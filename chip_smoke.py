#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py [--seed 0] [--out results.json]

Phases, each of which fails the run (nonzero exit) when it fails:
  1. the card's name and power limit (nvidia-smi);
  2. the build of every CUDA kernel of the port from its sources
     (simpleimagecaptionzoo_tpu_torch/csrc, one nvcc per source, in
     parallel), ptxas's registers, shared memory and spills of the
     tensor-core kernels and of K4's "tma" route, and their SASS:
     cuobjdump (or nvdisasm) must find HGMMA (wgmma), its tf32 form and
     UTMALDG (TMA loads) in libfused_lstm, libfused_head and
     libquant_matmul, the tf32 HGMMA and UTMALDG in each of the two
     "tf32x2" kernels (head_partial_tf32x2, quant_matmul_tf32x2) on its
     own, in each of K2 backward's four product kernels (liblstm_bwd:
     dx·dh and dW·db, the bf16 HGMMA in the wgmma pair, the tf32 one in
     the tf32x3 pair) UTMALDG and its HGMMA, and UTMALDG in
     libint8_attention;
  3. K1, the fused head top-k, against its plain PyTorch version on the card
     at the greedy decode shape (m=384, H=1024, V=10,102; k=1 and k=3), at
     m=3 and at the beam shape (m=1,152, k=3) on each dtype's tensor-core
     route (bf16: "wgmma"; float32: "tf32x3", three TF32 products), at the
     greedy shape on the CUDA-core route too, and on a cross-chunk tie on
     every route; each dtype timed in turns (old: CUDA cores, new, new,
     old) at m=384 and m=1,152, host-inclusive and device-only, beside
     cuBLAS's bare x @ W; at the SCST greedy baseline's rows (m=128, k=1)
     on each dtype's tensor-core route, timed in turns (new, x @ W, x @ W,
     new); and NIC's and AoASpatial's heads (H=512) at m=384
     k=1 and m=1,152 k=3 on each dtype's tensor-core route, timed in turns
     (new, x @ W, x @ W, new);
  4. K2, the fused LSTM cell, against its plain version (B=384, E=2048,
     H=1024, the unaligned E=200 and the beam rows B=1,152 on each dtype's
     tensor-core route; B=384 and E=200 on the CUDA-core route too); each
     dtype timed in turns against the CUDA-core route and torch.lstm_cell
     at B=384 and B=1,152; and the other families' cells at B=384 and
     1,152 on each dtype's tensor-core route, timed in turns against
     torch.lstm_cell: BUTD's two (E=4,096, the attention cell's [h2, mean,
     emb]; E=3,072, the language cell's [attended, h1]; H=1,024), NIC's
     (E=512, the word or image embedding; H=512) and AoASpatial's (E=1,024,
     [emb, ctx]; H=512); and, for XE training, K2 at the training rows
     (B=128) on each dtype's tensor-core route, and K2's backward kernel
     (the gate recompute and the gate gradients, fused_lstm_cell_bwd)
     against lstm_cell_bwd_plain on each route ("wgmma", "tf32x3", and
     "cuda_core" forced) at B=128 and 384 (E=2048, H=1024) and at E=200,
     d_gates and dc to K2's holds (1e-5 float32, rtol and atol 1e-2
     bf16); K2's whole backward (lstm_cell_bwd_full: the backward kernel,
     then the dx·dh and dW·db kernels of csrc/lstm_bwd.cu) at each cell
     the training paths run (AoADetection E=2,048 H=1,024, BUTD's td
     E=4,096 and lang E=3,072, NIC E=512 H=512, AoASpatial E=1,024 H=512)
     at B=128, 64 and 192 on each dtype's tensor-core route: three
     launches, the same bits twice, its five outputs to
     engine/holds.k2_bwd_full_errors (float32 against float64: dx, dh, dc
     1e-5; dW and db 1e-5 of the sums of |[x, h]||d| and |d|; bf16 rtol and
     atol 1e-2), the products' operands to their split's bound, and each
     product kernel against its plain version on the same d_gates; at
     E=200 the whole backward with float32 torch.matmul products and no
     product kernel; then per cell at B=128, timed in turns, host-inclusive
     and device-only: the whole backward through LstmCell, the matmul path
     (the backward kernel and three float32 torch.matmul products,
     composed here as a yardstick), torch.lstm_cell's backward through
     autograd (which keeps its gates), the backward kernel, dx·dh (float32:
     beside torch.mm(d_gates, w_cat^T)), dW·db, for AoADetection's cell
     the backward kernel on the CUDA cores, and the forward beside
     torch.lstm_cell's forward; each against its bound (the whole
     backward: the recompute, dx·dh and dW·db, w_cat read twice);
  5. K3, the int8 dequantizing product, against its plain version at the
     three shapes of the int8 decode step (the LSTM gates, aoa_dec.q,
     aoa_dec.aoa; m=384, and m=1,152 for the beam step), at BUTD's three
     (its cells' [x, h], K=5,120 and 4,096 to n=4,096; att_dec, 1,024 to
     1,024; m=384 and 1,152), at the 512-wide families' four (NIC's cell,
     1,024 to 2,048; AoASpatial's cell, 1,536 to 2,048, aoa_dec.q, 512 to
     512, aoa_dec.aoa, 1,024 to 1,024; m=384 and 1,152) and a ragged one
     (m=37, K=200, n=700) on each dtype's tensor-core route (bf16:
     "wgmma"; float32: "tf32x2", two TF32 products over q widened to
     float32 in shared memory), and at the same shapes on the CUDA-core
     route (forced); each step shape timed at both m in turns
     (old: CUDA cores, new, lib, lib, new, old), host-inclusive and
     device-only, against torch._weight_int8pack_mm (the other families'
     shapes in turns of old, new, lib, new, old, 10 launches a reading);
  6. K1-int8, the fused head over the int8 head weight, as in 3, on each
     dtype's tensor-core route ("wgmma", "tf32x2") and on the CUDA-core
     route (forced), each also at m=1,152, k=3; timed in turns (old, new,
     new, old); the cross-chunk tie with an int8 head on every route; and
     NIC's and AoASpatial's int8 heads (H=512) as in 3;
  7. K4, the int8 K/V attention, against its plain version (B=384, k=1
     and k=3, 36 boxes with 10-36 valid, 8 heads, float32 and bf16) on
     both routes ("tma": a sample's K and V requested whole by TMA, every
     head at once; "cuda_core", forced); each dtype and k timed in
     turns (old: cuda_core, new, new, old), host-inclusive and
     device-only;
  8. the main path: AoADetection greedy decode at full width (embed/hidden
     1024, 6 refine layers, 8 heads, 36 boxes, vocab 10,102; random weights
     from --seed), batch 384, 20 steps, through
     engine.steps.make_greedy_decode: in float32 (K1 and K2, every launch on
     the "tf32x3" route) and in bf16 (every launch on the "wgmma" route),
     and in int8 serving form, on model.quantize_decode_params with
     SICZ_TPU_INT8_KV=auto, in float32 (K3 three times a step, K1-int8 and
     K4 once, K2 never; every K3 and K1-int8 launch on "tf32x2") and in
     bf16 (the same, with every K3 and K1-int8 launch on "wgmma"); in both,
     every K4 launch on the "tma" route.  Each is run once
     with the plain versions (the reference) and three times through the
     kernels; the launch counts of the kernel runs, per route, must equal
     their decode steps times those multiples, every launch's shape
     (engine/holds.recording_shapes: rows, and k for K1 and K4, the width
     of x for K2 and K3) must be one the path expects, each once a step,
     and the ids must agree with the reference run.  One more decode per path runs under
     torch.profiler, which prints the device time by kernel and the
     device's idle share;
  9. the main path, beam: AoADetection beam-3 decode of the same model and
     batch, step cap 20, through engine.steps.make_beam_decode, on the same
     four paths.  Per step the launches per route are those of 8, with K1
     at m=1,152 and k=3, K2 and K3 over 1,152 rows and K4 at 3 query rows
     (every launch's shape is recorded).  Each path runs once with the
     plain versions and three times through the kernels (timed: captions/s
     is B over the median), once more with alphas (finite, summing to 1 on
     live steps, 0 on masked boxes), once with every kernel call held
     against its plain version on the same inputs to the kernel's own
     tolerance (engine/holds.held_calls), and once
     under torch.profiler.  The float32 ids must equal the plain run's in
     99 % of rows; in the other paths both runs' winners are rescored by
     the plain step (ops/decode.sequence_logprob), and every row's kernel
     winner must score no lower than the plain winner minus 2 x 20 steps x
     4 x K1's value hold (1e-4 float32, 2e-3 bf16).
     scripts/rehearse_beam_gate.py shows what these gates pass and fail;
 10. BUTDDetection in feature mode at the width of
     Configs/Models/BUTDDetection.json (embed, hidden and atten 1024,
     enc_dim 2048, vocab 10,102; 36 boxes with 10-36 valid; random weights
     from --seed), B=384, step cap 20: greedy as in 8 and beam 3 as in 9,
     on the same four paths.  Per step: K1 once and K2 twice (its two
     cells: the attention cell hoisted, as in the JAX package's default
     mode, E=2,048, [h2, emb] with encode's td_mean_gates as its gate term;
     the language cell E=3,072) in float32 and bf16; K1-int8 once and K3
     three times (K=5,120, 4,096 and att_dec's 1,024), K2 and K4 never, in
     int8 serving form; each on its dtype's tensor-core route;
 11. BUTDSpatial (49 unmasked grid regions, the same weights): beam 3 in
     bf16 and in int8 bf16, as in 10;
 12. NIC in feature mode at the width of Configs/Models/NIC.json (embed and
     hidden 512, enc_dim 2048, vocab 10,102; random weights from --seed),
     B=384, step cap 20: greedy as in 8 and beam 3 as in 9, on the same
     four paths.  Per step K1 once and K2 once (E=512) in float32 and bf16,
     K1-int8 once and K3 once (K=1,024) in int8 serving form, K4 never;
     the step -1 cell is one more K2 (or K3) launch a decode, over 384 rows
     in greedy and 1,152 (the broadcast lanes) in beam.  NIC has no
     attention: greedy returns no alphas, beam's are zeros;
 13. AoASpatial in feature mode at the width of
     Configs/Models/AoASpatial.json (embed and hidden 512, 8 heads of 64,
     6 refine layers, 49 unmasked regions), greedy and beam 3 on the same
     four paths, as in 8 and 9: K1 once and K2 once (E=1,024) a step; int8:
     K1-int8 once and K3 three times (K=1,536, 512 and 1,024), K2 never,
     and K4 never: the int8 K/V gate (dh % 128) refuses 64-wide heads, so
     encode keeps float K/V with SICZ_TPU_INT8_KV=auto;
 14. XE training of AoADetection at the same width through
     engine.steps.make_xe_train_step: B=128 with 36 valid boxes, captions
     padded to 22 (21 teacher-forced steps) from a seeded numpy draw, Adam
     at lr 2e-4, value clamp 0.1, label smoothing 0.1, in float32 and in
     bf16 over float32 master weights, scheduled sampling off (teacher
     forcing hoisted: the cell over mean + ctx, E=1,024, its embedding's
     projection the gate term) and on at 0.25 (E=2,048, [emb, mean +
     ctx]).  In each of the four: the first step's loss and gradient norms
     through the kernels against the plain versions (the same generator
     seeds give both the same dropout masks and draws; in float32 each
     leaf's gradient within 1e-4 of its norm beyond the plain float32
     run's own distance from the same step in float64, since each rounds
     its own products: chip_smoke.beyond_float64), one step through
     the plain versions and 8 through the kernels (per step K2's forward
     and whole backward 21 times each on the dtype's tensor-core route at
     B=128, exactly, the backward's three kernels once each a call; the
     loss falling; ms a step, samples/s, peak memory, TMA map encodes),
     one step with every K2 call, forward and whole backward, held
     against its plain version (engine/holds.held_calls; in float32 also
     K2's error shared by the batch's rows against float64, within
     K2_BIAS_TOL times the plain version's: chip_smoke.k2_bias), and one
     step under torch.profiler (device time by part, idle share; "K2 backward's
     float32 products", anything LstmCellBackward launches but its
     kernels, autograd's sums of its outputs and its cotangent copies,
     must read 0 ms);
 15. SCST training of AoADetection at the same width through
     engine.steps.make_scst_train_step: B=128 with 36 valid boxes, cap 20,
     7 references an image padded to 32 (6-20 ids each), an idf table of
     1.3M random keys and the references' own n-grams, the references'
     norms precomputed, Adam at the model json's scst_lr 2e-5 with the
     value clamp 0.25, float32 and bf16 over float32 masters.  In each: the
     first step against the plain versions (the plain greedy baseline
     against the kernel run's, 99 % of rows in float32, 99 % of first ids
     in bf16; the kernel run's rollout and baseline ids replayed through
     the plain versions: the rewards identical, the loss within 1e-5 /
     1e-2 of its scale, each leaf's gradient as in 14); 8 steps through
     the kernels (per step K1 once a greedy step taken at m=128, k=1, K2's
     forward that many plus 20 times and its whole backward 20 times
     (three launches each), every launch on the dtype's tensor-core
     route, exactly; loss and reward finite; ms a step, samples/s, peak
     memory); one step with every K1, K2 and K2-backward call held; one
     step under torch.profiler (device time by part: the two encodes, the
     greedy baseline, the rollout, the hoisted head and its logprobs, the
     reward, the backward, K2's backward kernel and its product kernels,
     autograd's sums of their outputs, Adam; "K2 backward's float32
     products" 0 ms, as in 14);
 16. BUTDDetection at examples/bench_train.py's shape (B=128, 36 boxes,
     vocab 9,962, captions padded to 22; the width of
     Configs/Models/BUTDDetection.json, random weights from --seed): XE
     (as in 14, scheduled sampling on at 0.25, Adam at the json's lr
     4e-4) and SCST (as in 15, the same references and table, scst_lr
     2e-5), float32 and bf16, 4 timed steps each; per step K2's forward
     and whole backward (three launches) for both cells (the attention
     cell hoisted, E=2,048 with td_mean_gates as its gate term; E=3,072)
     on the tensor-core route;
 17. captions from pixels: NIC, BUTDSpatial and AoASpatial at their
     published widths (vocab 10,102), each with the full ResNet-101
     (3, 4, 23, 3, random from --seed, one tree for the three), B=384
     photo-like uint8 images at 224 x 224 staged on the card.  The trunk
     on the card against the same resnet.apply on the CPU (4 images,
     init's (0, 1) statistics): float32 within 1e-4 relative norm, bf16
     within 2e-2.  Then its running statistics are set to a calibration
     batch's own (64 other images, one train-mode apply at momentum 1),
     the trunk is timed at B in bf16 beside its bound (7.8 G
     multiply-adds an image), and per family beam 3 in bf16, float32 and
     int8 bf16 and greedy in bf16 and float32 run as in 9-13 (routes,
     launches per step and shapes exact, every kernel call of a beam
     decode held, the greedy and beam gates), each plain reference on the
     feature map of the kernel run it is held against; NIC also greedy
     bf16 from a fast-ingest pad box (512, extents 112-512).  Every pooled
     feature is float32, (B, 2048) or (B, 49, 2048), finite.  Printed:
     captions/s from pixels, the encode's device ms and its share of the
     decode's busy time, the idle share, the peak memory;
 18. the CLI on the card: ``main.main(build_argparser().parse_args(...))``
     of the port, in-process, from a temporary directory holding a
     synthetic dataset in the reference layout (a 10,102-entry vocabulary,
     captions of 8-16 words from it, 36 x 2048 float32 bottom-up features
     and boxes an image, a packed uint8 image shard at 224): AoADetection at
     the width of Configs/Models/AoADetection.json (512 train, 128 val, 128
     test images) trains 1 epoch at B=128 (4 XE steps, the val greedy in 2
     batches of 64), resumes to epoch 2 in bf16 (--start_from checkpoint),
     runs 1 SCST epoch (4 steps; the idf npz written), evaluates the test
     split with beam 3 in float32, bf16 and int8 (K4 on) and samples one
     image; NIC from pixels (Configs/Models/NIC.json, the full ResNet-101,
     256 train images from the shard) trains 2 epochs with
     --cnn_finetune_start 1 and evaluates 64 test images with beam 3.
     Gates: every operation returns 0; the reference files exist
     (checkpoints, histories of 1 then 2 epochs, the scst_ files,
     metrics.jsonl, coco_caption/results/captions-generate.json); every
     launch on its tensor-core route (K4 on "tma"); 21 K2 forward
     launches an AoADetection XE step and 21 of each of the whole
     backward's three kernels, K1 and K2 once a step of
     each greedy val batch; the first eval batch of each decode dtype, and
     NIC's first XE step, with every kernel call held; the first epoch's
     XE loss finite and falling; each checkpoint, read back on the CPU,
     equal to the engine's tree bit for bit, all float32; NIC's ResNet
     unchanged after epoch 1, and after epoch 2 changed in layer4 alone;
     the sample's log with its caption and, without matplotlib, the line
     that says so.  Every launch shape of the run gets an entry of the
     kernels line (``<kernel>_<route>_cli_<shape>``), held and timed on the
     arguments the path gave it.  Printed: the engine's XE and SCST steps/s
     and its ms a step over phases 14-15's bare steps, eval captions/s per
     decode dtype, coco_eval seconds, checkpoint save and load ms, the
     phase's seconds (at most 90);
 19. serving on the card, from pixels, in a temporary directory: the
     vocabulary of phase 18, a best checkpoint of BUTDSpatial at the width
     of Configs/Models/BUTDSpatial.json with the full ResNet-101 (random
     from --seed, statistics calibrated as in 17) saved by the port's
     CheckpointManager, 512 photo-like JPEGs of 160-640 px a side and a
     corrupt file.  ``tools.caption_images.main`` over the directory (beam
     3, bf16 and int8, --batch 64); ``tools.caption_server`` built through
     ``build_argparser().parse_args`` and ``build_server`` on port 0, beam
     3 bf16 at --max_batch 16, 64 and 192 and at 64 int8 and greedy
     float32 (--max_wait_ms 20), each under 1, max_batch and 4 x max_batch
     concurrent client threads of a load generator in its own process
     (scripts/serve_load.py) POSTing JPEG files over 127.0.0.1.  Gates:
     every reply 200 with a caption, the corrupt upload 400 and skipped by
     the directory run; /stats rows_decoded = batches x max_batch; read
     after each server stopped,
     every launch on its dtype's tensor-core route and, a step, K1 once at
     m = 3 x max_batch (k=3) and K2 at E=2,048 (the hoisted attention
     cell) and 3,072 (int8: K3 at
     K=5,120, 4,096 and 1,024); each image's caption from the server and
     from the directory run equal to that image's in-process decode by the
     same bundle in full batches of max_batch; one padded batch of each
     bundle with every kernel call held and its winners gated against the
     plain versions (phase 17's gates).  Every launch shape gets an entry
     ``<kernel>_<route>_serve_<shape>``.  Printed beside the card's name
     and power limit: captions/s, mean batch fill and p50 / p99 latency
     per max_batch and N, the bundle's offline rate (cap 50, no HTTP), the
     host's ms per upload decode, the directory run's images/s, the idle
     share of a profiled batch, the build and warm seconds, and K2's TMA
     maps encoded by the warm decode and by the served batches after it;
 20. XE and SCST from pixels on the card: BUTDSpatial and AoASpatial at
     their published widths (XE with layer4 fine-tuned at the json's
     cnn_FT_lr, scheduled sampling at 0.25; SCST at scst_lr and
     scst_cnn_FT_lr), NIC's SCST, each in float32 and bf16 over float32
     masters, B=128 photo-like images at 224 with the full ResNet-101
     (random, statistics calibrated): phases 14-15's gates (the first step
     against the plain versions, the stem's and layers 1-3's gradients
     exactly zero and layer4's not; 2 timed steps with K2's forward and
     whole backward launches per step exact on the tensor-core route,
     NIC's step -1 cell among them; a step with every kernel call held;
     for the float32 variant of each run a profiled step whose parts hold
     the trunk's forward and cuDNN's backward through layer4, "K2
     backward's float32 products" 0 ms).  The ResNet's leaves come from
     the bf16 trunk in every compute dtype, so the float32 first step
     holds each by its difference from the plain run's (within 2e-2 of
     its norm, TRUNK_GRAD_TOL) and beyond_float64 the rest; in
     BUTDSpatial's float32 SCST the plain and float64 runs take the kernel
     run's ReLU branches, each branch that differs lying within FLIP_TOL
     of its tensor's largest |x| (chip_smoke.relu_branches: its attention
     ReLU sends pre-activations within rounding of 0 either way); K1
     at the 512-wide heads' training rows gets entries
     ``..._px_train_...``.  A run that fails its gates fails the phase
     after the other runs have run.  Phases 19 and 20 take at most 120 s
     together;
 21. mid-epoch resume, data parallel and reference checkpoints, within
     120 s (drive_phase21; alone: scripts/probe_phase21.py, on the CPU at
     small sizes: scripts/rehearse_phase21.py): (a) the CLI's XE (float32,
     bf16) and SCST (float32) of AoADetection at full width, B=128,
     --midepoch_save_steps 2, each run uninterrupted and SIGKILLed once
     epoch 2's resume point after step 2 committed (children of this
     script, all six at once), the killed one resumed here: params,
     Adam's moments, the step count and the CIDEr history identical;
     printed, each save's ms on the loop and in the background and its
     bytes; (b) two processes sharing the card under gloo at 2 x 64
     against one process at 128 (XE with scheduled sampling and dropout,
     SCST; the first step's loss within 1e-5, its all-reduced gradient
     within 1e-5 of the gradient's norm, the losses of 3 steps within
     1e-4, the params identical on both processes), BUTDSpatial XE from
     pixels at 2 x 32 (a float32 train-mode trunk: every BN layer's batch
     statistics within 1e-5 of the float64 ones of its own activations
     over both processes and within 1e-4 of one process's run on the 64,
     the running statistics identical on both, the loss within 1e-5) and
     eval beam 3 at 2 x 32 (the same ids on both processes, equal to one
     process's), every kernel call of their first steps and decode held;
     one process under NCCL, its first XE step bit-identical to the run
     without a group; printed, steps/s of both and the all-reduce's ms a
     step (torch.profiler); (c) a reference-shaped AoADetection
     state_dict (random from --seed) through
     tools.convert_reference_checkpoint, decoded beam 3 bf16 at B=384
     with every kernel call held and phase 9's gate, and back through
     tools.export_reference_checkpoint, the same bits.  Every launch
     shape gets an entry ``<kernel>_<route>_{mid,dist,ref}_<shape>``.
 22. the JAX default mode's LSTM input hoists on K2, within 60 s
     (drive_hoists; alone: scripts/probe_phase22.py): (a) K2 with its gate
     term (row r adds term row r // lanes) against its plain version,
     forward, backward kernel and whole backward, float32 against float64
     (1e-5) and bf16 (1e-2), d_term held as d_gates, on each dtype's
     tensor-core route and on the CUDA-core route, at BUTD's hoisted
     attention cell (E=2,048, H=1,024; B=384, and B=1,152 with lanes 3),
     BUTD's and AoA's teacher-forced cells (E=1,024, B=128), AoASpatial's
     (E=512, H=512) and NIC's (E=0, H=512): timed beside the plain version
     and torch.addmm + torch._thnn_fused_lstm_cell, bound, the backward's
     three kernels at the training rows likewise; (b) BUTDDetection greedy
     and beam 3 at B=384, float32 and bf16, the default mode against
     ``interpret``: float32 rows 99 % identical (beam: winners rescored
     within the beam gate's tol), bf16 beam within the beam gate (bf16
     greedy: every kernel call held, its ids against interpret's
     reported), every
     attention-cell launch K2 on its tensor-core route at
     E=2,048 (auto) or 4,096 (interpret), K2 twice a step in the trace
     and at most 2 library products a decode more than interpret's (the
     mean rows' projection in encode: none a step), auto's TMA map
     encodes at most interpret's;
     (c) XE at full width, B=128, scheduled sampling off, of
     BUTDDetection, AoADetection, AoASpatial (49 regions) and NIC,
     float32 and bf16, auto against
     interpret: the same dropout masks, K2's launches by shape exact,
     float32's first step against float64 (beyond_float64) in both modes,
     bf16 each mode against its plain run by phase 14's hold; (d) the
     device's ms by kind of (b) (K2, K1,
     library products, the rest) and by part of a profiled XE step in each
     mode, with the card's name and power limit.
     Entries ``..._butd_td_hoist[_beam]``, ``..._train_butd_td_hoist``,
     ``..._butd_td_tf``, ``..._tf`` (AoADetection), ``..._aoasp_tf``,
     ``..._nic_tf``; phases 10-11, 14, 16-17 and 19-20 credit their
     launches to them;
 23. the COCO14 dry run through the port and the mesh's model axis, within
     90 s (drive_phase23; alone: scripts/probe_phase23.py, on the CPU at
     small sizes: scripts/rehearse_phase23.py): (a)
     ``tools/reproduce_coco14.dry_run`` in this process, on the card, of
     AoADetection (bottom-up features: the TSV through
     ``preprocess/generate_bottom_up_features`` generate and pack) and NIC
     (pixels: ``preprocess/pack_images`` at 224, the full ResNet-101), each
     at the width of its Configs/Models json: the fixture
     (tools/make_coco14_fixture.py, 16 JPEGs, Karpathy json), the port's
     preprocessing, its CLI's XE, SCST and eval at the shell script's tiny
     run's flags, every file the shell script's dry run asserts and every
     CLI's exit code 0; K1, K2 and K2's backward launched, each launch
     shape an entry (``..._dry_aoadet_...``, ``..._dry_nic_...``) held
     against its plain version on the path's own inputs; (b) two processes
     under gloo sharing the card (children ``--phase23-mp``), the
     (data, model) mesh with a model axis of 2: AoADetection at full width,
     each process's vocab shard of the head (5,051 columns, K1 at Vp=5,120)
     and its top-k merged across the two (parallel/vocab_shard.py): greedy
     and beam 3 at B=384, cap 20, float32 and bf16, against one process on
     the whole head (float32 greedy ids identical, float32 beam by phases
     8-9's float32 gate, bf16 beam by the beam gate; K1 once a greedy step
     taken and as often as one process in beam search, every call on the
     shard), one XE step at B=128 float32 (Adam, dropout on: the loss
     within 1e-5 of one process's, the updated head's shards within 1e-5
     of its update), every K1 call of a float32 greedy and a bf16 beam
     decode held; printed beside the card's name and power limit: each
     process's K1 on its shard (device-only), the merge's ms a greedy step
     (its ``vocab_shard.topk_merge`` span), captions/s of the two against
     one process.  K1's launch shapes of (b) get entries
     ``fused_head_topk_<route>_shard_<shape>``;
 24. the synthetic-data quality gate through the port, within PHASE24_S:
     (a) ``simpleimagecaptionzoo_tpu_torch/examples/train_synthetic.py`` in
     this process at the settings of
     ``QUALITY_r04_AoADetection_zipf.json`` (AoADetection, 2,000 generated
     images with power-law content words, 5 XE and 4 SCST epochs, beam
     tolerance 0.05, every other flag at its default: 256 wide, batch 64),
     every kernel launch recorded: its record must read PASS, the XE best
     val CIDEr at least the threshold (0.9), the SCST best above the XE
     best and beam 3 at most the tolerance below greedy; K1, K2 and K2's
     backward launched, each launch shape an entry (``..._gate_aoadet_...``)
     held against its plain version on the path's own inputs; printed
     beside the card's name and power limit: the record, each stage's
     seconds (dataset, preprocessing, XE, the test eval, the val evals,
     SCST, the sample) and each epoch's XE and SCST steps/s; (b) the two
     demos: ``examples/demo_e2e.py --model AoADetection --steps 60`` must
     read ``DEMO_RESULT: OK``; ``examples/demo_scst.py`` at its defaults
     must keep at least 0.8 of its greedy CIDEr-D with finite rewards, and
     its result is printed as read (its rewards' trend, the rule's third
     part, carries the rollout's dropout noise: the JAX demo reads WEAK on
     the CPU at its defaults).
Then it prints one JSON line of each timed phase's seconds beside its
budget and the share used (``{"phase_budgets": ...}``: phases 18, 19-20,
21, 22, 23 and 24), one JSON line of per-kernel results (the beam shapes'
launches as entries of their own, named ``..._beam``; BUTD's K2 and K3
shapes as ``..._butd_<layer>``, NIC's and AoASpatial's K1, K2 and K3 shapes
as ``..._nic[_<layer>]`` and ``..._aoasp[_<layer>]``; K2's backward as
``fused_lstm_cell_bwd[_<route>]``, its products as ``lstm_bwd_dxh_<route>``
and ``lstm_bwd_dw_<route>``, and its forward at the training rows as
``fused_lstm_cell_<route>_train`` (BUTD's cells: ``..._butd_td`` and
``..._butd_lang``; NIC's and AoASpatial's ``..._nic``, ``..._aoasp``);
K1 at the training rows as ``fused_head_topk_<route>_train``; an entry's
``launches`` is the sum over the main paths' reading runs that launched it,
``launches_by_path`` per path) and, last, the ``{"ok": true, "device":
...}`` line.

Timings use CUDA events, with a 128 MB buffer written between launches so
each launch finds the L2 cache cold (as in the decode, where the other
step's weights pass through L2 in between).  A reading includes the host's
time when the host issues a call more slowly than the card runs it; the
tensor-core routes of K1, K2, K3 and K1-int8, and both routes of K4, are
also timed with the card kept busy while the host launches them
(``device_*``: the device's time alone).  The float32 CUDA-core routes of
K1, K2, K3 and K1-int8, the bf16 ones of K3 and K1-int8 and K4's
"cuda_core" route keep their entries (``launches`` 0: no decode runs
them).
``bound_ms`` is the larger of the bytes the function must move over 3.35
TB/s and its operations over the peak rate for their type and route (989
TFLOP/s bf16 tensor cores; 67 TFLOP/s float32 on the CUDA cores; for the
3xTF32 routes a third of the 494.7 TFLOP/s TF32 peak, as each float32
operation is three TF32 ones; for float32 x with an int8 weight, the
"tf32x2" routes, a third of the bf16 rate, the card's best for that
function: q is exact in bf16 and x in three bf16 parts keeps 27 bits, so
three bf16 products keep float32 accuracy (the 2xTF32 scheme's own rate,
half the TF32 peak, is printed beside it as ``scheme_bound_ms``); K4's
float32 arithmetic at the CUDA-core rate whatever q's type), the H100 SXM
data-sheet figures at 700 W.
An int8 weight is counted at one byte; its product runs at x's type.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
# a 3xTF32 product does three TF32 products' operations: its float32
# operations run at a third of the 494.7 TFLOP/s TF32 peak.  Float32 x
# times an int8 weight ("tf32x2") is bound at a third of the bf16 rate:
# three bf16 products (x in three bf16 parts, q exact in bf16) keep
# float32 accuracy, faster than the route's own 2xTF32 ("2xtf32")
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12,
                  "tf32x3": 494.7e12 / 3, "tf32x2": 989e12 / 3,
                  "2xtf32": 494.7e12 / 2}
B, MAX_LEN, N_BOX, BEAM = 384, 20, 36, 3
# XE training (phase 14): TrainConfig.train_batch_size, captions padded to
# max_caption_len 22 (21 teacher-forced steps), Adam at the model json's lr
TRAIN_B, TRAIN_T, TRAIN_LR, TRAIN_SS = 128, 22, 2e-4, 0.25
# BUTDDetection training (phase 16) at examples/bench_train.py's shape:
# its vocabulary, steps timed per variant
BENCH_VOCAB, BENCH_STEPS = 9962, 4
N_GRID = 49                   # BUTDSpatial: a 7 x 7 grid of ResNet features
HERE = os.path.dirname(os.path.abspath(__file__))
FULL = dict(model_type="AoADetection", vocab_size=10102, embed_dim=1024,
            hidden_dim=1024, enc_dim=2048, num_heads=8, num_refine_layers=6,
            max_bu_len=N_BOX)


def require(cond, msg):
    if not cond:
        raise RuntimeError("chip_smoke: FAILED: " + msg)


def log(*a):
    print(*a, flush=True)


def time_ms(torch, fn, flush, reps=20, lead=0):
    """Median milliseconds of ``fn()`` over ``reps`` launches, each after
    the L2 flush.  The host does not wait between launches, so where a
    call's host work outlasts the flush the gap is timed too.  ``lead``
    (GPU clock cycles, e.g. 500,000: about 0.25 ms) keeps the card busy
    after the flush while the host issues ``fn``: the reading is then the
    device's time alone."""
    for _ in range(3):
        fn()
    evs = []
    for _ in range(reps):
        flush.zero_()
        if lead:
            torch.cuda._sleep(lead)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    t = sorted(s.elapsed_time(e) for s, e in evs)
    return t[len(t) // 2]


def time_turns(torch, fns, flush, order, reps=50, lead=0):
    """``time_ms`` of each callable of ``fns`` (name -> fn) in ``order``,
    e.g. old, new, new, old on the same card; name -> its readings."""
    out = {}
    for name in order:
        out.setdefault(name, []).append(time_ms(torch, fns[name], flush,
                                                reps, lead))
    return out


DEVICE_LEAD = 500_000        # cycles of GPU sleep ahead of a device-only reading


def mean(xs):
    return sum(xs) / len(xs)


def _tool(name):
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", name),
                 "/usr/local/cuda/bin/" + name, shutil.which(name) or ""):
        if cand and os.path.isfile(cand):
            return cand
    return None


SASS_OPS = ("HGMMA", "UTMALDG", "HGMMA.64x128x8.F32.TF32")


def sass_text(_build, name, lib):
    """The SASS of the built library of ``csrc/<name>.cu``: cuobjdump -sass
    on the library, or, without cuobjdump, nvdisasm on a cubin of the same
    source."""
    cuobjdump = _tool("cuobjdump")
    if cuobjdump:
        return subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                              text=True, timeout=120, check=True).stdout
    nvdisasm = _tool("nvdisasm")
    require(nvdisasm, "neither cuobjdump nor nvdisasm found")
    cubin = lib + ".cubin"
    subprocess.run([_build.nvcc_path(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-cubin", "-I", _build.CSRC_DIR, "-o", cubin,
                    os.path.join(_build.CSRC_DIR, name + ".cu")],
                   check=True, capture_output=True, timeout=300)
    return subprocess.run([nvdisasm, cubin], capture_output=True, text=True,
                          timeout=120, check=True).stdout


def sass_counts(text, ops=SASS_OPS):
    """How often each SASS opcode of ``ops`` occurs in ``text`` (HGMMA
    counts every wgmma, the last one the tf32 products of the "tf32x3" and
    "tf32x2" routes)."""
    return {op: text.count(op) for op in ops}


def sass_functions(text):
    """{mangled kernel name: its SASS} from cuobjdump's ("Function : name")
    or nvdisasm's (".text.name:") listing."""
    parts = re.split(r"Function : (\S+)|^\s*\.text\.(\S+):", text,
                     flags=re.M)
    return {parts[i] or parts[i + 1]: parts[i + 2]
            for i in range(1, len(parts) - 2, 3)}


def ptxas_lines(lib, markers=("wgmma", "tf32x3", "tf32x2")):
    """ptxas's report (-Xptxas -v, kept in <library>.log) of the kernels
    whose mangled name holds one of ``markers``: the tensor-core ones."""
    lines, keep = [], 0
    for line in open(lib + ".log").read().splitlines():
        if "Compiling entry function" in line:
            keep = 3 if any(m in line for m in markers) else 0
            if keep:
                lines.append(line.split("'")[1])
            continue
        if keep:
            lines.append("  " + line.strip())
            keep -= 1
    return lines


def counts(mod, tf32="tf32x3"):
    """(every launch, "wgmma" launches, launches of the float32 route
    ``tf32``) of a kernel's counters: "tf32x3" for K1 and K2, "tf32x2" for
    K3 and K1-int8."""
    return mod.COUNT.n, mod.COUNT_WGMMA.n, getattr(mod, "COUNT_"
                                                   + tf32.upper()).n


def moved(now, before):
    return tuple(a - b for a, b in zip(now, before))


def launched(route, n=1, tf32="tf32x3"):
    """How ``n`` launches on ``route`` move :func:`counts`."""
    return n, n * (route == "wgmma"), n * (route == tf32)


def bound(nbytes, nops, rate):
    """Milliseconds: the larger of the bytes over HBM's rate and the
    operations over PEAK_OPS_PER_S[rate], and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = nops / PEAK_OPS_PER_S[rate]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def k2_fwd_size(rows, e, hd, item, lanes=0):
    """(bytes, operations) of K2's forward at one shape: x, h and c read,
    w_cat and b_sum read once, h' and c' written; with a gate term (lanes
    >= 1) its rows / lanes rows read once.  Operations: the product,
    2 rows (E+H) 4H."""
    n4 = 4 * hd
    nbytes = (rows * (e + 4 * hd) + (e + hd) * n4 + n4) * item
    if lanes:
        nbytes += rows // lanes * n4 * item
    return nbytes, 2 * rows * (e + hd) * n4


def k2_library(torch, w_cat, b_sum, x, h, c, term=None, lanes=1):
    """One call of PyTorch's own for K2's function on these operands:
    torch.lstm_cell without a gate term; with one, the term's rows (made
    once, outside the call) with x @ w_x added by torch.addmm, h @ w_hh,
    then torch._thnn_fused_lstm_cell (the gate math CUDA's LSTMCell runs)."""
    e = x.shape[1]
    w_x, w_h = w_cat[:e], w_cat[e:]
    if term is None:
        lib_w = [w_x.t().contiguous(), w_h.t().contiguous(), b_sum,
                 torch.zeros_like(b_sum)]
        return lambda: torch.lstm_cell(x, (h, c), *lib_w)
    rows_t = term if lanes == 1 else term.repeat_interleave(lanes, dim=0)
    # the op takes both biases or neither
    zero = torch.zeros_like(b_sum)

    def lib():
        ig = torch.addmm(rows_t, x, w_x) if e else rows_t
        return torch.ops.aten._thnn_fused_lstm_cell(ig, h @ w_h, c, b_sum,
                                                    zero)[:2]
    return lib


# K2's whole backward is held at the XE and SCST rows and at the engine's
# eval rows (phase 18)
K2_BWD_ROWS = (TRAIN_B, 64, 192)


def product_counts(fused_lstm):
    """(every launch, "wgmma" launches, "tf32x3" launches) of K2 backward's
    dx·dh kernel, then the same of its dW·db kernel."""
    return tuple(c.n for c in k2_product_counters(fused_lstm).values())


def k2_bwd_bounds(rows, e, hd, item, route, lanes=0):
    """Bounds of K2's backward at one shape, name -> (ms, "bytes" or
    "operations", bytes, operations): "gate", the backward kernel writing
    d_gates, dc and the products' operands (bf16: d's two bf16 parts;
    float32: d^T's two TF32 parts); "gate_cc", the same without the
    operands (the CUDA-core route); "dxh", dx·dh; "dw", dW·db; "full", the
    whole backward (the inputs and cotangents read once, w_cat twice, the
    five outputs written once); "saved", the whole backward had the
    forward saved its gates (ROADMAP Queue 2: no recompute, w_cat read
    once, the gates read).  P = 2 B (E+H) 4H, one product's operations:
    the recompute is one, each of dx·dh and dW two (2xBF16) at the bf16
    rate, or one at the 3xTF32 rate (a third of TF32's).  With a gate term
    (``lanes`` >= 1) the gate kernel also reads the term's rows / lanes
    rows and, in bf16, writes d_term (B, 4H); in float32 d_term is
    d_gates, already counted."""
    n4 = 4 * hd
    p = 2 * rows * (e + hd) * n4
    w = (e + hd) * n4 * item
    bf = route == "wgmma"
    rate = "bfloat16" if bf else "tf32x3"
    prod_ops = (2 if bf else 1) * p
    parts = 2 * rows * n4 * (2 if bf else 4)
    ins = rows * (e + 4 * hd) * item                  # x, h, c, dh', dc'
    if lanes:
        ins += rows // lanes * n4 * item              # the term
    gate_cc = ins + w + n4 * item + rows * n4 * 4 + rows * hd * item
    if lanes and bf:
        gate_cc += rows * n4 * item                   # d_term
    # the function's outputs: dW, db, dx, dh, dc, and the term's gradient
    outs = rows * (e + 2 * hd) * item + (rows // lanes * n4 * item
                                         if lanes else 0)
    sizes = dict(
        gate=(gate_cc + parts, p), gate_cc=(gate_cc, p),
        dxh=(w + (parts if bf else rows * n4 * 4) + rows * (e + hd) * item,
             prod_ops),
        dw=(rows * (e + hd) * item + parts + rows * n4 * 4 + w + n4 * item,
            prod_ops),
        full=(ins + 2 * w + n4 * item + w + n4 * item + outs,
              (5 if bf else 3) * p),
        saved=(ins + rows * n4 * item + w + n4 * item + w + n4 * item
               + outs, (4 if bf else 2) * p))
    return {k: bound(nb, no, rate) + (nb, no) for k, (nb, no) in
            sizes.items()}


def hold_head(torch, fused_head, tag, head, x, dn, tol, extra=(),
              route=None):
    """K1 (any weight type) against its plain version at k=1, k=3, on
    three rows and on the ``extra`` (x, k) cases, through ``topk_head`` or,
    given ``route``, on that route; returns the largest error of values and
    lse."""
    err = 0.0
    cases = ([(x, k) for k in (1, 3)] + [(x[:3].contiguous(), 3)]
             + list(extra))
    for xs, k in cases:
        if route is None:
            kv, ki, kl = fused_head.topk_head(head, xs, k)
        else:
            kv, ki, kl = fused_head._run_kernel(head, xs, k, route)
        torch.cuda.synchronize()
        pv, pi, pl = fused_head.topk_head_plain(head, xs, k + 1)
        e = max(float((kv - pv[:, :k]).abs().max()),
                float((kl - pl).abs().max()))
        require(e <= tol, "%s %s m=%d k=%d: max |err| %.3g > %g"
                % (tag, dn, xs.shape[0], k, e, tol))
        # ids must match where the plain logits leave a gap > 1e-3 on
        # both sides of the position
        gaps = pv[:, :-1] - pv[:, 1:]                 # (m, k)
        lo = torch.cat([torch.full_like(gaps[:, :1], float("inf")),
                        gaps[:, :k - 1]], dim=1)
        sure = (gaps[:, :k] > 1e-3) & (lo > 1e-3)
        bad = int(((ki != pi[:, :k]) & sure).sum())
        require(bad == 0, "%s %s m=%d k=%d: %d ids differ where the gap "
                "exceeds 1e-3" % (tag, dn, xs.shape[0], k, bad))
        log("%s %s m=%d k=%d: max|err| %.3g (tol %g); ids exact at %d of "
            "%d positions with gap > 1e-3, %d of %d equal overall"
            % (tag, dn, xs.shape[0], k, e, tol, int(sure.sum()), sure.numel(),
               int((ki == pi[:, :k]).sum()), ki.numel()))
        err = max(err, e)
    return err


def _busy(spans):
    """Device-busy microseconds of sorted (start, end, name) spans: their
    union's length."""
    busy, end = 0.0, spans[0][0]
    for s, e, _ in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    return busy


def profile_decode(torch, run, dn, top=16):
    """Device time of one decode by kernel name, and the device's busy
    share of the traced span, from torch.profiler tracing the device alone
    (host ops are not traced: a from-pixels decode's trunk adds thousands
    of them, whose tracing slows the run and stretches the span), read
    from the trace's raw events (:func:`raw_events`)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda_t = torch.autograd.DeviceType.CUDA
    spans = sorted((s, e, name) for ev, name, s, e in raw_events(
        torch, prof.profiler.kineto_results) if ev.device_type() == cuda_t)
    require(spans, "profile %s: the trace holds no device time" % dn)
    busy = _busy(spans)
    by_name = {}
    for s, e, n in spans:
        tot, cnt = by_name.get(n, (0.0, 0))
        by_name[n] = (tot + (e - s), cnt + 1)
    span_ms = (spans[-1][1] - spans[0][0]) / 1e3
    out = dict(wall_ms=wall_ms, device_span_ms=span_ms,
               device_busy_ms=busy / 1e3, kernels=[])
    log("profile %s: host wall %.2f ms, device span %.2f ms, busy %.2f ms "
        "(idle %.1f%% of the span), %d kernel launches"
        % (dn, wall_ms, span_ms, busy / 1e3, 100 * (1 - busy / 1e3 / span_ms),
           len(spans)))
    for n, (tot, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[
            :top]:
        out["kernels"].append(dict(name=n, ms=tot / 1e3, count=cnt))
        log("  %8.3f ms %5d x  %s" % (tot / 1e3, cnt, n[:90]))
    return out


# the ranges chip_smoke wraps around the XE step's parts (phases 14 and
# 16) and the SCST step's (phases 15 and 16), in the order a step runs them
XE_RANGES = ("xe:encode", "xe:teacher_forcing", "xe:loss", "xe:optimizer")
SCST_RANGES = ("scst:greedy_baseline", "scst:encode", "scst:rollout",
               "scst:hoisted_head", "scst:reward", "scst:loss",
               "scst:optimizer")


# the parts of a training step's profile that K2's backward launches
# besides its kernels: what autograd's LstmCellBackward node launched, by
# the operation that launched it
K2_PRODUCTS_PART = "K2 backward's float32 products"
K2_BWD_OPS = {"aten::add": "autograd's sums of K2 backward's outputs",
              "aten::add_": "autograd's sums of K2 backward's outputs",
              "aten::copy_": "K2 backward's cotangent copies"}


# K2's backward kernel by its name, demangled or not: the tensor-core
# kernels' first template argument (BWD; the second is TERM), the CUDA-core
# kernel's second (its first is the type)
K2_BWD_KERNEL = re.compile(r"lstm_cell_(?:wgmma|tf32x3)(?:<true|ILb1E)"
                           r"|lstm_cell_kernel(?:<[^,<>]+, true|I\w+Lb1E)")


def k2_product_counters(fused_lstm):
    """The counters of K2 backward's dx·dh and dW·db kernels, by the names
    of a step's launch gates."""
    return dict(lstm_bwd_dxh=fused_lstm.COUNT_DXH,
                lstm_bwd_dxh_wgmma=fused_lstm.COUNT_DXH_WGMMA,
                lstm_bwd_dxh_tf32x3=fused_lstm.COUNT_DXH_TF32X3,
                lstm_bwd_dw=fused_lstm.COUNT_DW,
                lstm_bwd_dw_wgmma=fused_lstm.COUNT_DW_WGMMA,
                lstm_bwd_dw_tf32x3=fused_lstm.COUNT_DW_TF32X3)


# the part of a from-pixels step's profile that autograd's convolution
# nodes launch: cuDNN's backward through layer4 (the only convolutions with
# a gradient: the stem and layers 1-3 are detached, the images need none)
TRUNK_BWD_PART = "cuDNN's backward through layer4's convolutions"


def require_trunk_parts(profile, tag, trunk_range):
    """From pixels the profile holds the trunk's forward (``trunk_range``)
    and cuDNN's backward through ``layer4``, each with device time."""
    parts = profile["parts_ms"]
    require(parts.get(trunk_range, 0.0) > 0
            and parts.get(TRUNK_BWD_PART, 0.0) > 0,
            "%s: the profile's parts %s lack the trunk's forward or "
            "cuDNN's backward through layer4" % (tag, sorted(parts)))


# the ResNet's gradients (layer4's, from pixels) come from the bf16 trunk
# in every compute dtype (resnet.apply's default, as in the JAX package),
# so a float32 step holds each of them by the norm of its difference from
# the plain run's, over the plain gradient's norm, within 2e-2 (phase 14's
# bf16 bound; 6.5e-3 to 6.9e-3 measured, PERF.md section 6); the float32
# rule (beyond_float64) holds the rest
TRUNK_GRAD_TOL = 2e-2


def trunk_split(names, rel):
    """-> (the indices of the ResNet's leaves, the largest of ``rel`` over
    them (0 without one))."""
    trunk = [i for i, n in enumerate(names) if n.startswith("cnn.")]
    return trunk, max([rel[i] for i in trunk], default=0.0)


# how near zero a ReLU's pre-activation may take the other branch in the
# plain or the float64 replay than in the kernel run, over the largest |x|
# of its tensor (relu_branches): above every sound run's flip (8.0e-8 the
# largest over 12 draws of the data) and below what a shift of K2's h' by
# 1e-5 of its largest |h'|, K2's hold, reads (8.2e-7; 1e-6 reads 7.4e-8);
# scripts/probe_scst_pixels.py --relu --plant, PERF.md section 6
FLIP_TOL = 2.5e-7


@contextlib.contextmanager
def relu_branches(torch, masks, flips=None, on=True):
    """The first training step's gradients are a function of each ReLU's
    branch, and a pre-activation within rounding of 0 takes either: the
    kernel run and the plain or the float64 run would differ there by that
    element's whole cotangent, which moves a small leaf by much more than
    rounding (BUTD's attention biases, whose gradient is a thousandth of
    the largest leaf's; scripts/probe_scst_pixels.py --relu).  So the
    kernel run records each ``torch.relu`` call's branch (x > 0) into
    ``masks`` (``flips`` None), and the replays take them, each call the
    next recorded mask of its shape (x times the mask), appending to
    ``flips`` each call's (elements whose branch the replay's own x would
    have changed, their largest |x| over the tensor's largest |x|).  A
    replay call of a shape the kernel run never made takes its own branch:
    the SCST replay's teacher forcing, hoisted in the default mode, ReLUs
    the embeddings of every step at once where the rollout ReLU'd one step
    at a time, and an embedding (a table lookup) has the same bits in every
    run.  Only ``torch.relu``'s call sites are replayed (the trunk's
    ``F.relu`` is not: its leaves are held by TRUNK_GRAD_TOL), and only
    where a run failed without it (``on``): BUTDSpatial's float32 SCST
    from pixels (drive_scst's ``relu_replay``) and phase 22's float32 BUTD
    XE."""
    if not on:
        yield
        return
    relu = torch.relu
    queues = {}
    for m in masks:
        queues.setdefault(tuple(m.shape), []).append(m)
    calls = {shape: iter(q) for shape, q in queues.items()}

    def record(x):
        masks.append(x > 0)
        return relu(x)

    def replay(x):
        if tuple(x.shape) not in calls:
            return relu(x)
        m = next(calls[tuple(x.shape)], None)
        require(m is not None, "relu_branches: the replay makes more ReLU "
                "calls of shape %s than the kernel run" % (tuple(x.shape),))
        d = (x > 0) != m
        n = int(d.sum())
        top = float(x.detach().abs().max())
        flips.append((n, float(x.detach().abs()[d].max()) / max(top, 1e-30)
                      if n else 0.0))
        return x * m.to(x.dtype)

    torch.relu = record if flips is None else replay
    try:
        yield
    finally:
        torch.relu = relu


def check_flips(flips, tag):
    """Every flipped branch within FLIP_TOL of 0: a kernel that moved a
    pre-activation further than rounding fails here.  -> (flips, the
    largest relative |x| of one)."""
    n = sum(k for k, _ in flips)
    top = max([f for _, f in flips], default=0.0)
    require(top <= FLIP_TOL, "%s: %d ReLU branches differ between the "
            "kernel run and the plain or float64 replay, one at %.3g of its "
            "tensor's largest |x| (tol %g)" % (tag, n, top, FLIP_TOL))
    return n, top


# K2's float32 error shared by the batch's rows (k2_bias): the kernel's
# mean over columns of |its error's mean over rows| against float64, at
# most this many times the plain float32 version's.  The tf32x3 route
# reads 1.1x-5.5x (h') and 1.1x-7.3x (c') over the float32 held steps of
# phases 14-16 and 20, and a copy that starts a fresh partial every k8
# step 1.1x-1.2x (scripts/probe_scst_pixels.py --variants); PERF.md
# sections 6-7
K2_BIAS_TOL = 10.0


@contextlib.contextmanager
def k2_bias(torch, acc, on=True):
    """Every float32 K2 forward call in the block is also run through its
    plain version in float32 and in float64; ``acc`` gets, for h' and c',
    the mean over calls of the mean over columns of |the error's mean over
    the batch's rows| for the kernel and for the plain version: the part
    of the error the batch's sums do not average out, which K2's hold
    (each element within 1e-5) does not see."""
    from simpleimagecaptionzoo_tpu_torch.ops import fused_lstm
    if not on:
        yield
        return
    run = fused_lstm.lstm_cell_fused
    sums = {}

    def measured(*a, **kw):
        got = run(*a, **kw)
        if a[2].dtype == torch.float32:
            term, lanes = kw.get("term"), kw.get("lanes", 1)
            with torch.no_grad():
                want = fused_lstm.lstm_cell_plain(
                    *(t.double() for t in a[:5]),
                    None if term is None else term.double(), lanes)
                plain = fused_lstm.lstm_cell_plain(*a[:5], term, lanes)
                for how, out in (("kernel", got), ("plain", plain)):
                    for nm, g, w in zip(("h", "c"), out, want):
                        d = (g.detach().double() - w).reshape(-1, w.shape[-1])
                        k = "%s_%s" % (how, nm)
                        sums[k] = sums.get(k, 0.0) + float(
                            d.mean(0).abs().mean())
            sums["calls"] = sums.get("calls", 0) + 1
        return got

    fused_lstm.lstm_cell_fused = measured
    try:
        yield
    finally:
        fused_lstm.lstm_cell_fused = run
        n = sums.pop("calls", 0)
        acc.update({k: v / n for k, v in sums.items()}, calls=n)


def check_k2_bias(bias, tag):
    """The kernel's row-shared error within K2_BIAS_TOL times the plain
    version's, for h' and c' (a no-op where :func:`k2_bias` was off)."""
    if not bias:
        return
    ratio = {nm: bias["kernel_" + nm] / max(bias["plain_" + nm], 1e-30)
             for nm in ("h", "c")}
    bias["ratio"] = ratio
    log("%s: K2's error shared by the batch's rows over %d calls, mean "
        "over columns of |its mean over rows| against float64: h' %.3g "
        "(plain %.3g, %.2fx), c' %.3g (plain %.3g, %.2fx; tol %gx)"
        % (tag, bias["calls"], bias["kernel_h"], bias["plain_h"],
           ratio["h"], bias["kernel_c"], bias["plain_c"], ratio["c"],
           K2_BIAS_TOL))
    require(bias["calls"] > 0 and max(ratio.values()) <= K2_BIAS_TOL,
            "%s: K2's row-shared error %s times the plain version's "
            "(tol %g) over %d calls" % (tag, ratio, K2_BIAS_TOL,
                                        bias["calls"]))


def check_fine_tune_scope(params, grads, tag):
    """The first step's gradients (``grads``, in ``params``' leaf order):
    the ResNet's stem and layers 1-3 exactly zero, ``layer4``'s not
    (engine/steps._stop_cnn_grads, layer4 fine-tuned).  -> the count of
    zero and nonzero ResNet leaves."""
    from simpleimagecaptionzoo_tpu_torch.engine import optim
    names = optim.tree_leaves(_paths(params))
    stopped = [(n, g) for n, g in zip(names, grads)
               if n.startswith("cnn.") and not n.startswith("cnn.layer4")]
    tuned = [(n, g) for n, g in zip(names, grads)
             if n.startswith("cnn.layer4")]
    moving = [n for n, g in stopped if bool(g.any())]
    require(stopped and tuned and not moving
            and any(bool(g.any()) for _, g in tuned),
            "%s: the fine-tune scope: %d stem/layers 1-3 leaves with a "
            "gradient (%s), layer4's all zero: %s" % (
                tag, len(moving), moving[:3],
                not any(bool(g.any()) for _, g in tuned)))
    return dict(zero_leaves=len(stopped), layer4_leaves=len(tuned),
                layer4_nonzero=sum(bool(g.any()) for _, g in tuned))


def part_seconds(stamps, tag):
    """Seconds of a training variant's parts (the first step against the
    plain versions, the timed steps, the held step and the profiled step),
    from the times taken at their starts; logged."""
    stamps = stamps + [time.time()]
    out = dict(zip(("first_step", "timed", "held", "profiled"),
                   (b - a for a, b in zip(stamps, stamps[1:]))))
    log("%s: seconds %s" % (tag, {k: round(v, 2) for k, v in out.items()}))
    return out


def run_split(res, seconds):
    """A training run's seconds (``seconds``, its wall) by part, summed
    over its variants (:func:`part_seconds`), with the profiled steps'
    host seconds by stage (:func:`profile_step`)."""
    out = {"wall": round(seconds, 2)}
    for v in res.values():
        for k, x in v.get("variant_seconds", {}).items():
            out[k] = round(out.get(k, 0.0) + x, 2)
        for k, x in v.get("profile", {}).get("host_s", {}).items():
            out["profile_" + k] = round(out.get("profile_" + k, 0.0) + x, 2)
    return out


def require_no_products(profile, tag):
    """On the tensor-core routes K2's backward is its three kernels: no
    other product under LstmCellBackward."""
    ms = profile["parts_ms"].get(K2_PRODUCTS_PART, 0.0)
    require(ms == 0.0, "%s: %s read %.4f ms a step; the tensor-core "
            "routes run none" % (tag, K2_PRODUCTS_PART, ms))


EVALUATE = "autograd::engine::evaluate_function"


def op_label(op, anchor, ranges):
    """The part of a launch by the CPU operation ``op`` whose nearest
    enclosing range of ``ranges`` or autograd node (itself included) is
    ``anchor`` (None: none encloses it)."""
    if anchor is None:
        return "other"
    if anchor in ranges:
        return anchor
    if "LstmCellBackward" in anchor:
        return K2_BWD_OPS.get(op, K2_PRODUCTS_PART)
    if "ConvolutionBackward" in anchor:
        return TRUNK_BWD_PART
    return "backward, other"


def kernel_part(label, kernel):
    """The part of a kernel launched under ``label`` (:func:`op_label`):
    K2's own kernels by their names, wherever they were launched."""
    if "lstm_cell" in kernel:
        return ("K2 backward kernel" if K2_BWD_KERNEL.search(kernel)
                else "K2 forward kernel")
    if "lstm_bwd_" in kernel:
        return "K2 backward's product kernels"
    return label


def function_events(torch, result):
    """torch's own FunctionEvent tree of a trace's raw kineto events
    (``result``), as ``prof.events()`` builds it: the reference reading's
    input (:func:`parts_by_function_events`)."""
    from torch.autograd.profiler_util import EventList
    prof = torch.autograd.profiler.profile()
    prof.use_device = "cuda"
    tree = EventList(prof._parse_kineto_results(result), use_device="cuda")
    tree._build_tree()
    return tree


def parts_by_function_events(torch, events, ranges):
    """Device ms by part from torch's FunctionEvent tree
    (:func:`function_events`): each kernel-bearing CPU operation's
    ``cpu_parent`` chain walked.  The reference for :func:`read_trace`,
    which reads the same from the raw events
    (tests/test_torch_smoke_profile.py, and on the card
    scripts/probe_phase19_20.py --check)."""
    parts = {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        anc = e
        while anc is not None and not (anc.name in ranges
                                       or anc.name.startswith(EVALUATE)):
            anc = anc.cpu_parent
        label = op_label(e.name, None if anc is None else anc.name, ranges)
        for k in e.kernels:
            part = kernel_part(label, k.name)
            parts[part] = parts.get(part, 0.0) + k.duration / 1e3
    return parts


def event_namer():
    """-> name(event): a raw kineto event's name as torch's own parser
    rewrites it, or None for an event that parser leaves out (its utility
    operations, hidden events); each distinct name rewritten once."""
    from torch.autograd.profiler_util import _filter_name, _rewrite_name
    names = {}

    def name(ev):
        raw = ev.name()
        got = names.get(raw)
        if got is None:
            got = names[raw] = (False if _filter_name(raw)
                                else _rewrite_name(raw, with_wildcard=True))
        if got is False or getattr(ev, "is_hidden_event", bool)():
            return None
        return got
    return name


def raw_events(torch, result):
    """A trace's raw kineto events (``result``: the profiler's
    ``kineto_results``) as torch's own parser keeps them: -> (event, its
    name (:func:`event_namer`), start µs, end µs from the trace's start),
    in the trace's order."""
    t0 = result.trace_start_ns()
    name_of = event_namer()
    for ev in result.events():
        name = name_of(ev)
        if name is not None:
            yield ev, name, (ev.start_ns() - t0) / 1000, \
                (ev.end_ns() - t0) / 1000


def read_trace(torch, result, ranges):
    """One pass over a trace's raw kineto events (``result``: the
    profiler's ``kineto_results``), without torch's FunctionEvent tree:
    -> dict(spans: the device's kernels and copies as sorted (start µs,
    end µs, name), the record_function ranges placed on the device's
    timeline left out; parts: device ms by part, each kernel counted to
    the part of the CPU operation that launched it (:func:`op_label`,
    :func:`kernel_part`); k2_host_ms: the host's ms in K2's backward
    nodes).  A part depends on the launching operation's name and on its
    nearest enclosing range or autograd node alone, so of the CPU
    operations only those that launched a kernel and those ranges and
    nodes are kept, and nest as torch nests them (per thread, by their
    intervals: what encloses an operation encloses it in any subset); each
    operation's nearest range or node is found once, shared by the
    operations under it.  The CUDA runtime calls, which torch nests under
    the operation that made them, are left out.  It reads what
    :func:`parts_by_function_events` reads from torch's tree, but for
    kernels launched by an operation that torch folds into its only child
    of the same name (EventList._remove_dup_nodes keeps the child's
    kernels alone)."""
    cpu_t, cuda_t = torch.autograd.DeviceType.CPU, \
        torch.autograd.DeviceType.CUDA
    t0 = result.trace_start_ns()
    name_of = event_namer()
    spans, launched, cpu = [], {}, []
    for i, ev in enumerate(result.events()):
        dtype, linked = ev.device_type(), ev.linked_correlation_id()
        on_cpu = dtype == cpu_t
        if on_cpu and linked > 0 or not (on_cpu or dtype == cuda_t):
            continue
        name = name_of(ev)
        if name is None:
            continue
        if not on_cpu:
            s, e = (ev.start_ns() - t0) / 1000, (ev.end_ns() - t0) / 1000
            if linked > 0:
                launched.setdefault(linked, []).append((name, e - s))
            if not ev.is_user_annotation() and name not in ranges:
                spans.append((s, e, name))
        else:
            cpu.append((i, ev, name))
    ops = []          # [start, -end, order, thread, name, corr, sync]
    for i, ev, name in cpu:
        corr = ev.correlation_id()
        if corr not in launched and not (name in ranges
                                         or name.startswith(EVALUATE)):
            continue
        thread = ev.start_thread_id()
        ops.append([(ev.start_ns() - t0) / 1000, -(ev.end_ns() - t0) / 1000,
                    i, thread, name, corr,
                    not ev.is_async() and thread == ev.end_thread_id()])
    ops.sort()
    # each synchronous operation's parent: per thread a stack of the
    # intervals still open, as EventList._populate_cpu_children
    parent = {}
    by_thread = sorted((op for op in ops if op[6]), key=lambda op: op[3])
    stack, thread = [], None
    for op in by_thread:
        if op[3] != thread:
            stack, thread = [], op[3]
        while stack:
            top = stack[-1]
            if op[0] >= -top[1] or -op[1] > -top[1]:
                stack.pop()
            else:
                parent[op[2]] = top
                break
        stack.append(op)
    anchor = {}

    def anchor_of(op):
        path = []
        while op is not None and op[2] not in anchor:
            if op[4] in ranges or op[4].startswith(EVALUATE):
                anchor[op[2]] = op[4]
                break
            path.append(op[2])
            op = parent.get(op[2])
        found = None if op is None else anchor[op[2]]
        for i in path:
            anchor[i] = found
        return found

    parts, k2_host_us = {}, 0.0
    for op in ops:
        if op[4].startswith(EVALUATE + ": LstmCellBackward"):
            k2_host_us += -op[1] - op[0]
        if not op[6] or op[5] not in launched:
            continue
        label = op_label(op[4], anchor_of(op), ranges)
        for kname, dur in launched[op[5]]:
            part = kernel_part(label, kname)
            parts[part] = parts.get(part, 0.0) + dur / 1e3
    spans.sort()
    return dict(spans=spans, parts=parts, k2_host_ms=k2_host_us / 1e3)


def profile_step(torch, run, tag, ranges=XE_RANGES):
    """One training step under torch.profiler: the device's busy share of
    the traced span, and device time by part.  A kernel counts to the K2
    forward or backward kernel, or to K2 backward's product kernels (dx·dh,
    dW·db), by its name; when autograd's LstmCellBackward launched another,
    to autograd's sums of its outputs into their consumers' gradients
    (aten::add), to its cotangent copies (aten::copy_) or to "K2
    backward's float32 products" (the CUDA-core route's torch.matmul
    products, and anything else); to the other backward when another
    autograd node launched it, and otherwise to the innermost of
    ``ranges`` (XE_RANGES, SCST_RANGES) around its launch (wrapped around
    the parts by the caller).  The trace is read from its raw events
    (:func:`read_trace`); ``host_s`` holds the host's seconds of the traced
    step, the profiler's start and stop, and the reading."""
    from torch.profiler import ProfilerActivity, profile
    t_in = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        wall_ms = (t_end - t0) * 1e3
    t_stop = time.perf_counter()
    read = read_trace(torch, prof.profiler.kineto_results, ranges)
    spans, parts = read["spans"], read["parts"]
    require(spans, "profile %s: the trace holds no device time" % tag)
    busy = _busy(spans) / 1e3
    span_ms = (spans[-1][1] - spans[0][0]) / 1e3
    # kernels the trace links to no CPU operation
    parts["unattributed"] = (sum(e - s for s, e, _ in spans) / 1e3
                             - sum(parts.values()))
    by_name = {}
    for s, e, n in spans:
        tot, cnt = by_name.get(n, (0.0, 0))
        by_name[n] = (tot + (e - s) / 1e3, cnt + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    host_s = dict(start=t0 - t_in, step=t_end - t0, stop=t_stop - t_end,
                  read=time.perf_counter() - t_stop)
    out = dict(wall_ms=wall_ms, device_span_ms=span_ms, device_busy_ms=busy,
               idle_share_of_span=1 - busy / span_ms,
               kernel_launches=len(spans), parts_ms=parts,
               k2_backward_host_ms=read["k2_host_ms"], host_s=host_s,
               kernels=[dict(name=n, ms=t, count=c) for n, (t, c) in top])
    log("profile %s: host wall %.2f ms, device span %.2f ms, busy %.2f ms "
        "(idle %.1f%% of the span), %d kernel launches, the host in K2's "
        "backward nodes %.2f ms; device ms by part: %s; host seconds %s"
        % (tag, wall_ms, span_ms, busy, 100 * (1 - busy / span_ms),
           len(spans), read["k2_host_ms"], ", ".join(
               "%s %.3f" % kv for kv in sorted(parts.items(),
                                                key=lambda kv: -kv[1])),
           {k: round(v, 3) for k, v in host_s.items()}))
    for n, (t, c) in top:
        log("  %8.3f ms %5d x  %s" % (t, c, n[:90]))
    return out


XE_STEPS = 8                  # steps through the kernels per variant


def beyond_float64(k_grads, p_grads, e_grads, skip=()):
    """The float32 first step's gradient gate, against the step in float64
    (``e_grads``: the plain versions, params and features in float64).
    Per leaf, the norm of the kernel run's difference from float64 and the
    plain float32 run's, each over the float64 gradient's norm (floored at
    1e-3 of the largest leaf's).  -> (the largest excess of the kernel
    run's over the plain run's, the largest of each, the worst three
    leaves by excess as (excess, kernel's, plain's, index)), over the
    leaves not in ``skip`` (the floor is the whole tree's).  The kernel
    run passes where no leaf lies more than the tolerance further from
    float64 than the plain float32 run does: where both float32 runs share
    a product, that is the old gate against the plain run (the triangle
    inequality), and where each rounds its own products it still asks for
    float32's accuracy: BUTDDetection's attention leaves are 7.8e-4 to
    8.8e-4 of their norm from float64 in both runs
    (scripts/probe_grads_f64.py)."""
    norms = [float(t.double().norm()) for t in e_grads]
    floor = 1e-3 * max(norms)
    held = [i for i in range(len(norms)) if i not in set(skip)]

    def rel(a):
        return [float((a[i].double() - e_grads[i].double()).norm())
                / max(norms[i], floor) for i in held]
    ek, ep = rel(k_grads), rel(p_grads)
    excess = [a - b for a, b in zip(ek, ep)]
    worst = sorted(zip(excess, ek, ep, held))[-3:]
    return max(excess), max(ek), max(ep), worst


# -- phase 17: captions from pixels --------------------------------------
# ResNet-101's multiply-adds per 224 x 224 image (torchvision's published
# figure), for the trunk's operation bound
RESNET101_MACS = 7.8e9
CAL_B = 64                   # the calibration batch (not the served one)
TRUNK_F32_TOL = 1e-4         # the card's float32 trunk against the CPU's
TRUNK_BF16_TOL = 2e-2        # bf16 (tests/test_torch_resnet.py's bound)


def photo_batch(torch, gen, n, side, dev):
    """``n`` photo-like uint8 images (n, side, side, 3) on ``dev``, drawn
    from ``gen``: smoothed noise over a gradient and a checkerboard
    (examples/bench_ingest.py's recipe), each image with its own gradient
    angle, checker period and channel mix."""
    import math
    img = torch.randint(0, 255, (n, side, side, 3), generator=gen,
                        device=dev).float()
    for _ in range(3):
        img = (img.roll(1, 1) + img.roll(-1, 1) + img.roll(1, 2)
               + img.roll(-1, 2) + img) / 5
    ax = torch.arange(side, device=dev, dtype=torch.float32) / side
    angle = torch.rand(n, generator=gen, device=dev)[:, None, None] \
        * (2 * math.pi)
    ramp = (torch.cos(angle) * ax[None, None, :]
            + torch.sin(angle) * ax[None, :, None] + 1) / 2
    period = torch.tensor([8, 16, 32, 64], device=dev)[torch.randint(
        0, 4, (n,), generator=gen, device=dev)][:, None, None]
    idx = torch.arange(side, device=dev)
    checker = ((idx[None, :, None] // period + idx[None, None, :] // period)
               % 2).float()
    mix = torch.rand(n, 1, 1, 3, 2, generator=gen, device=dev)
    img = (img * 0.3 + mix[..., 0] * ramp[..., None] * 200
           + mix[..., 1] * checker[..., None] * 120)
    return img.clamp(0, 255).to(torch.uint8)


def calibrated_stats(torch, cnn, stats, images):
    """The ResNet's running statistics set to ``images``' own (uint8): one
    train-mode ``apply`` in float32 with ``BN_MOMENTUM`` at 1.  Random
    weights with ``init``'s (0, 1) statistics give features around 1e5,
    where every decoder saturates; these keep them O(1), as a trained
    backbone's are."""
    from simpleimagecaptionzoo_tpu_torch.models import resnet
    from simpleimagecaptionzoo_tpu_torch.ops import image
    momentum, resnet.BN_MOMENTUM = resnet.BN_MOMENTUM, 1.0
    try:
        with torch.inference_mode():
            _, cal = resnet.apply(cnn, stats, image.normalize(images),
                                  dtype=torch.float32, train=True)
    finally:
        resnet.BN_MOMENTUM = momentum
    return cal


class TrunkMemo:
    """Stands in for ``models.resnet.apply`` (which the models call through
    the module) while phase 17 drives a path: in "record" mode it runs the
    trunk and keeps the feature map, in "pass" it runs it, in "replay" it
    returns the kept map without running.  So the plain reference run of a
    decode reads the same encode's features as the kernel run it is held
    against: with calibrated random weights the trunk amplifies any
    difference between two encodes (an algorithm choice in cuDNN) far
    enough to move ids, which would say nothing of K1-K3."""

    def __init__(self, resnet):
        self.resnet, self.apply = resnet, resnet.apply
        self.mode, self.fmap = "record", None
        resnet.apply = self

    def __call__(self, *a, **kw):
        if self.mode == "replay":
            return self.fmap
        out = self.apply(*a, **kw)
        if self.mode == "record":
            self.fmap = out
        return out

    def replaying(self):
        import contextlib

        @contextlib.contextmanager
        def ctx():
            mode, self.mode = self.mode, "replay"
            try:
                yield
            finally:
                self.mode = mode
        return ctx()

    def close(self):
        self.resnet.apply = self.apply


def rel_err(torch, got, want):
    """Relative norm of got - want, in float64."""
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def trunk_breakdown(torch, run):
    """Device ms and launches of one ``run()`` by kind of kernel, from
    torch.profiler: "conv" (cuDNN's convolution kernels and their
    layout transforms), "elementwise" (BatchNorm's scale and shift, ReLU,
    the residual add, the weights' cast and relayout), "pool"."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out = {}
    cuda_t = torch.autograd.DeviceType.CUDA
    for ev, name, s, e in raw_events(torch, prof.profiler.kineto_results):
        if ev.device_type() != cuda_t:
            continue
        name = name.lower()
        kind = ("pool" if "pool" in name else
                "elementwise" if "elementwise" in name else "conv")
        k = out.setdefault(kind, {"ms": 0.0, "launches": 0})
        k["ms"] += (e - s) / 1e3
        k["launches"] += 1
    require(out, "the trunk's trace holds no device time")
    return out


def drive_pixels(torch, dev, gen, smi, flush, steps, drive_greedy,
                 drive_beam, families):
    """Phase 17: captions from pixels.  One full ResNet-101 (3, 4, 23, 3)
    drawn from ``gen`` serves NIC, BUTDSpatial and AoASpatial (each
    family's feature-mode params plus ``cnn``).

    Gate 1: the trunk on the card against the same ``resnet.apply`` on the
    CPU, 4 images, ``init``'s (0, 1) running statistics: float32 (cuDNN,
    TF32 off) within TRUNK_F32_TOL relative norm, bf16 within
    TRUNK_BF16_TOL.  Then the running statistics are set to a calibration
    batch's own (CAL_B other images, one train-mode apply at momentum 1),
    so the features are O(1) as a trained backbone's are.  The ResNet is
    timed at B in bf16 beside its operation bound, and the image ops
    (normalize; fast ingest's resample of a 512 pad box) beside it.

    Gate 2: per family beam 3 in bf16, float32 and int8 bf16 and greedy in
    bf16 and float32 (``family_paths``: routes, launch counts and shapes
    exact, every kernel call of a beam decode held, the greedy and beam
    gates), each plain reference on the same encode's feature map as the
    kernel run it is held against (TrunkMemo); NIC also greedy bf16 from a
    fast-ingest pad box (extents 112-512).  Gate 3: every pooled feature
    the decodes make is float32 of the family's shape, the last finite.
    Printed: captions/s from pixels, the encode's device ms and its share
    of the decode's busy time, the idle share, the peak memory."""
    from simpleimagecaptionzoo_tpu_torch.engine.optim import tree_leaves
    from simpleimagecaptionzoo_tpu_torch.models import resnet
    from simpleimagecaptionzoo_tpu_torch.ops import image as image_ops
    torch.cuda.reset_peak_memory_stats()
    t17 = time.time()
    out = {"card": smi, "seconds": {}}
    cnn, stats0 = resnet.init(gen)
    images = photo_batch(torch, gen, B, 224, dev)
    torch.cuda.synchronize()

    # gate 1: the card's trunk against the CPU's
    x4 = image_ops.normalize(images[:4])
    cnn_cpu, stats_cpu = (steps._cast_floats(t, None, "cpu")
                          for t in (cnn, stats0))
    out["trunk_hold"] = {}
    for dt, tol in ((torch.float32, TRUNK_F32_TOL),
                    (torch.bfloat16, TRUNK_BF16_TOL)):
        dn = str(dt).split(".")[1]
        with torch.inference_mode():
            got = resnet.apply(cnn, stats0, x4, dtype=dt).float().cpu()
            want = resnet.apply(cnn_cpu, stats_cpu, x4.cpu(),
                                dtype=dt).float()
        err = rel_err(torch, got, want)
        out["trunk_hold"][dn] = err
        require(bool(torch.isfinite(got).all()) and err < tol,
                "ResNet-101 %s on the card against the CPU: relative error "
                "%.3g (tol %g)" % (dn, err, tol))
        log("ResNet-101 %s, 4 images, init's statistics: the card against "
            "the CPU %.3g relative norm (tol %g); features up to %.3g"
            % (dn, err, tol, float(want.abs().max())))
    del cnn_cpu, stats_cpu
    out["seconds"]["trunk_hold"] = time.time() - t17

    cal = calibrated_stats(torch, cnn, stats0,
                           photo_batch(torch, gen, CAL_B, 224, dev))
    ms = {"cnn_stats": cal}

    # the trunk and the image ops at B, bf16 (as a bf16 decode casts cnn)
    visual = {"img_tensors": images}
    box = photo_batch(torch, gen, B, image_ops.INGEST_PAD, dev)
    fast = {"img_tensors": box, "img_hw": torch.randint(
        112, image_ops.INGEST_PAD + 1, (B, 2), generator=gen, device=dev,
        dtype=torch.int32)}
    cnn_bf = steps._cast_floats(cnn, torch.bfloat16)
    x = image_ops.normalize(images)
    with torch.inference_mode():
        fmap = resnet.apply(cnn_bf, cal, x)
        trunk_ms = time_ms(torch, lambda: resnet.apply(cnn_bf, cal, x),
                           flush, reps=5)
        norm_ms = time_ms(torch, lambda: image_ops.prepare_images(visual),
                          flush, reps=5)
        resize_ms = time_ms(torch, lambda: image_ops.prepare_images(fast),
                            flush, reps=5)
    nbytes = (x.numel() * 4 + fmap.numel() * 2
              + sum(t.numel() * 2 for t in tree_leaves(cnn_bf)))
    b_ms, b_by = bound(nbytes, 2 * RESNET101_MACS * B, "bfloat16")
    out["trunk"] = dict(ms=trunk_ms, images_per_s=B / trunk_ms * 1e3,
                        bound_ms=b_ms, bound_by=b_by,
                        share_of_bound=b_ms / trunk_ms,
                        params=sum(t.numel() for t in tree_leaves(cnn)),
                        normalize_ms=norm_ms, fast_ingest_resize_ms=resize_ms,
                        fmap_abs_mean=float(fmap.float().abs().mean()))
    log("ResNet-101 bf16 at B=%d (%s): %.3f ms, %.1f images/s; bound %.3f "
        "ms (%s, %.3g MACs an image), %.1f %% of it; %d parameters; "
        "normalize %.3f ms, fast-ingest resample (pad %d) %.3f ms; "
        "calibrated features' mean |y| %.3f"
        % (B, smi, trunk_ms, B / trunk_ms * 1e3, b_ms, b_by, RESNET101_MACS,
           100 * b_ms / trunk_ms, out["trunk"]["params"], norm_ms,
           image_ops.INGEST_PAD, resize_ms, out["trunk"]["fmap_abs_mean"]))
    out["trunk"]["by_kind"] = trunk_breakdown(
        torch, lambda: resnet.apply(cnn_bf, cal, x))
    log("ResNet-101 bf16 at B=%d, device ms by kind of kernel (one traced "
        "apply): %s" % (B, ", ".join(
            "%s %.3f ms in %d launches" % (k, v["ms"], v["launches"])
            for k, v in out["trunk"]["by_kind"].items())))
    del x, fmap
    out["seconds"]["trunk_timed"] = time.time() - t17

    # gate 3's recorder: every pooled feature the decodes make
    pooled, originals = [], {}
    for fname in ("global_pool", "spatial_features"):
        originals[fname] = orig = getattr(resnet, fname)

        def rec(*a, _orig=orig, **kw):
            y = _orig(*a, **kw)
            pooled.append((tuple(y.shape), y.dtype, y))
            return y
        setattr(resnet, fname, rec)

    def check_pooled(tag, shape):
        require(pooled and all(s == shape and d == torch.float32
                               for s, d, _ in pooled)
                and bool(torch.isfinite(pooled[-1][2]).all()),
                "%s: pooled features %s, expected %s float32, finite"
                % (tag, sorted({(s, str(d)) for s, d, _ in pooled}), shape))
        n = len(pooled)
        pooled.clear()
        return n

    memo = TrunkMemo(resnet)
    mk = B * BEAM
    try:
        for fam, model, base, paths_of, shape, kv in families:
            name = fam + " from pixels"
            prm = dict(base, cnn=cnn)
            qprm = model.quantize_decode_params(prm)
            require(qprm["cnn"] is cnn, "%s: int8 serving changed cnn" % fam)
            r = out[fam] = {}
            r["beam"] = drive_beam(
                name, model, visual,
                [p for p in paths_of(mk, BEAM, True, prm, qprm)
                 if p[0] in ("bfloat16", "float32", "int8/bfloat16")],
                model_state=ms, memo=memo)
            r["pooled_checked"] = check_pooled(name + " beam", shape)
            greedy = [p for p in paths_of(B, 1, False, prm, qprm)
                      if p[0] in ("bfloat16", "float32")]
            r["decode"] = drive_greedy(name, model, visual, greedy,
                                       kv_int8=kv, model_state=ms,
                                       memo=memo)
            r["pooled_checked"] += check_pooled(name + " greedy", shape)
            if fam == "NIC":
                r["fast_ingest"] = drive_greedy(
                    name + " (fast ingest)", model, fast,
                    [p for p in greedy if p[0] == "bfloat16"],
                    model_state=ms, memo=memo)
                r["pooled_checked"] += check_pooled(name + " fast", shape)
            r["encode_ms"] = {}
            for dt in (torch.bfloat16, torch.float32):
                dn = str(dt).split(".")[1]
                p_c = steps._cast_floats(prm, dt, dev)
                v_c = steps._cast_floats(visual, dt, dev)
                with torch.inference_mode():
                    r["encode_ms"][dn] = time_ms(
                        torch, lambda: model.encode(p_c, v_c, model_state=ms),
                        flush, reps=3)
            pooled.clear()
            out["seconds"][fam] = time.time() - t17
            for kind in ("beam", "decode"):
                for label, res in r[kind].items():
                    dn = "float32" if label == "float32" else "bfloat16"
                    busy = res["profile"]["device_busy_ms"]
                    wall = sorted(res["seconds"])[1] * 1e3
                    res["encode_ms"] = r["encode_ms"][dn]
                    res["encode_share_of_busy"] = r["encode_ms"][dn] / busy
                    res["idle_share_of_wall"] = 1 - busy / wall
                    log("%s %s %s (%s): %.1f captions/s from pixels; encode "
                        "%.2f ms, %.1f %% of the decode's %.2f ms busy; idle "
                        "%.1f %% of the wall"
                        % (name, "beam 3" if kind == "beam" else "greedy",
                           label, smi, res["captions_per_s"],
                           res["encode_ms"],
                           100 * res["encode_share_of_busy"], busy,
                           100 * res["idle_share_of_wall"]))
    finally:
        memo.close()
        for fname, orig in originals.items():
            setattr(resnet, fname, orig)
    out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log("phase 17 peak memory %.2f GiB (%s); seconds since its start %s"
        % (out["peak_memory_gib"], smi,
           {k: round(v, 1) for k, v in out["seconds"].items()}))
    return out


def _paths(tree, prefix=""):
    """The same structure with each leaf replaced by its path, e.g.
    "refine[2].aoa.k.b"."""
    if isinstance(tree, dict):
        return {k: _paths(v, "%s.%s" % (prefix, k) if prefix else k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_paths(v, "%s[%d]" % (prefix, i))
                          for i, v in enumerate(tree))
    return prefix


def stub_entry(kernels, ename):
    """The entry ``ename`` of the kernels line, made bare (its name and
    route) where a path launches a shape before the phase that holds and
    times it (phase 22's hoisted cells); that phase fills in the rest, and
    main() refuses an entry left without the contract's keys."""
    return kernels.setdefault(ename, dict(name=ename, route="cuda"))


def credit_launches(kernels, on_path, tag, n, *enames):
    """Adds ``n`` launches of path ``tag`` to each entry of ``enames`` (its
    ``launches_by_path``, and ``launches`` their sum) and marks it as on
    the main path."""
    for ename in enames:
        by_path = stub_entry(kernels, ename).setdefault("launches_by_path",
                                                       {})
        by_path[tag] = by_path.get(tag, 0) + n
        kernels[ename]["launches"] = sum(by_path.values())
        on_path.add(ename)


def drive_xe(torch, args, dev, model, params, kernels, on_path, *, name,
             cells, lr, variants, n_timed=XE_STEPS, visual=None,
             model_state=None, lr_cnn=0.0, profiled=None, tf_cells=None):
    """XE training through engine.steps.make_xe_train_step (phase 14:
    AoADetection; phase 16: BUTDDetection), B=128 with 36 valid boxes and
    captions padded to 22 (21 teacher-forced steps), Adam at ``lr`` with
    the value clamp 0.1 and label smoothing 0.1; ``variants``: (dtype
    name, compute dtype, scheduled sampling on at 0.25).  ``cells``: (entry
    suffix, width of x) of each LSTM cell a step runs; ``tf_cells``, when
    given, those of the variants with scheduled sampling off, where the
    default mode hoists teacher forcing's input projections (each cell
    then runs over what stays in the step, with its gate term).  In each
    variant: the first step's loss and every leaf's gradient norm through
    the
    kernels against the plain versions (the same generator seeds, so the
    same dropout masks and draws); one step through the plain versions,
    then ``n_timed`` through the kernels from the same state (the first
    one's loss against the plain step's; K2's forward and backward 21 times
    a step per cell, all on the dtype's tensor-core route at B=128 and the
    cell's E; the loss falling; ms per step, samples/s, peak memory, TMA
    map encodes); one step with every K2 call, forward and backward, held
    against its plain version; one step under torch.profiler.

    From pixels (phase 20), ``visual`` holds ``img_tensors`` and
    ``model_state`` the ResNet's running statistics: the step fine-tunes
    ``layer4`` at ``lr_cnn`` (train-mode BN), the first step's gradients
    of the stem and layers 1-3 must be exactly zero and ``layer4``'s not
    (:func:`check_fine_tune_scope`), and the profile adds the trunk's
    forward ("xe:trunk") and cuDNN's backward through ``layer4``.
    ``profiled``: the dtype names of the variants profiled (all when
    None)."""
    import numpy as np
    from simpleimagecaptionzoo_tpu_torch.engine import holds, optim, steps
    from simpleimagecaptionzoo_tpu_torch.engine.state import TrainState
    from simpleimagecaptionzoo_tpu_torch.ops import decode, fused_lstm
    v, enc_dim = model.config.vocab_size, model.config.enc_dim
    n_steps = TRAIN_T - 1
    rng = np.random.default_rng(args.seed)
    caps = rng.integers(4, v, size=(TRAIN_B, TRAIN_T))
    caps[:, 0] = 1
    lens = rng.integers(8, TRAIN_T, size=(TRAIN_B,))
    for i, n in enumerate(lens):
        caps[i, n - 1] = 2
        caps[i, n:] = 0
    g0 = torch.Generator(device=dev).manual_seed(args.seed + 1)
    if visual is None:
        visual = {
            "bu_feats": torch.relu(torch.randn(TRAIN_B, N_BOX, enc_dim,
                                               generator=g0, device=dev)),
            "bu_masks": torch.ones(TRAIN_B, N_BOX, device=dev)}
    batch = {"visual": visual,
             "captions": torch.from_numpy(caps).to(dev),
             "lengths": torch.from_numpy(lens).to(dev)}
    ms0 = {} if model_state is None else model_state
    pixels = "img_tensors" in visual
    labels = model.param_labels(params)
    counters = dict(fused_lstm_cell=fused_lstm.COUNT,
                    fused_lstm_cell_wgmma=fused_lstm.COUNT_WGMMA,
                    fused_lstm_cell_tf32x3=fused_lstm.COUNT_TF32X3,
                    fused_lstm_cell_bwd=fused_lstm.COUNT_BWD,
                    fused_lstm_cell_bwd_wgmma=fused_lstm.COUNT_BWD_WGMMA,
                    fused_lstm_cell_bwd_tf32x3=fused_lstm.COUNT_BWD_TF32X3,
                    **k2_product_counters(fused_lstm))

    def gen():
        return torch.Generator(device=dev).manual_seed(args.seed + 2)

    # the parts the profile names (XE_RANGES)
    from torch.profiler import record_function

    def ranged(name, fn):
        def run(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return run

    from simpleimagecaptionzoo_tpu_torch.models import resnet
    saved = (model.encode, decode.teacher_forced_logits,
             steps.label_smoothing_loss, steps.apply_updates_partitioned,
             resnet.apply)
    model.encode = ranged("xe:encode", saved[0])
    decode.teacher_forced_logits = ranged("xe:teacher_forcing", saved[1])
    steps.label_smoothing_loss = ranged("xe:loss", saved[2])
    steps.apply_updates_partitioned = ranged("xe:optimizer", saved[3])
    resnet.apply = ranged("xe:trunk", saved[4])
    out = {}
    try:
        for label, cdtype, ss in variants:
            dn = label
            route = "tf32x3" if cdtype is None else "wgmma"
            f32 = cdtype is None
            # the first step against the plain versions: float32 holds each
            # leaf's gradient to 1e-4 of its norm beyond the plain float32
            # run's own distance from the step in float64 (beyond_float64;
            # the loss to 1e-5 of the plain run's); bf16 holds each leaf's
            # gradient norm to 2e-2 and reports
            # the difference: there K2's h' may round to the other side of
            # a bf16 boundary than the plain version's (K2's hold is 1e-2),
            # which moves a leaf's gradient by about 1 % (0.0097 measured),
            # and with scheduled sampling on such a flip can change a drawn
            # token, which moves gradient to another row of the embedding
            # table (0.031 of its norm measured)
            loss_tol, grad_tol = (1e-5, 1e-4) if f32 else (1e-2, 2e-2)
            vcells = cells if ss or tf_cells is None else tf_cells
            t_parts = [time.time()]
            tag = "xe %s %s, scheduled sampling %s" % (
                name, label, "on at %g" % TRAIN_SS if ss else "off")
            ss_prob = TRAIN_SS if ss else 0.0
            adam = optim.make_grad_transform("Adam", 0.1)
            tx = optim.GradientTransformation(
                adam.init, ranged("xe:optimizer", adam.update))
            step = steps.make_xe_train_step(
                model, tx, labels, smoothing=0.1, compute_dtype=cdtype,
                ss_active=ss, device="cuda")
            state0 = TrainState.create(params, tx, ms0)

            def loss_grads(dtype=cdtype):
                leaves = [p.detach().requires_grad_()
                          for p in optim.tree_leaves(params)]
                loss, _, _ = steps.xe_loss(
                    model, steps._stop_cnn_grads(
                        optim.tree_unflatten(params, leaves), False), ms0,
                    batch, gen(), ss_prob, smoothing=0.1,
                    compute_dtype=dtype, ss_active=ss,
                    ss_generator=steps.draw_generator_for(gen(), 0,
                                                          dev))
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
                return float(loss.detach()), [
                    torch.zeros_like(p) if g is None else g
                    for p, g in zip(leaves, grads)]

            k_loss, k_grads = loss_grads()
            scope = (check_fine_tune_scope(params, k_grads, tag) if pixels
                     else None)
            with holds.plain_versions():
                p_loss, p_grads = loss_grads()
                # float32: the same step in float64, the gradients' own
                # reference (beyond_float64)
                e_grads = loss_grads(torch.float64)[1] if f32 else None
            # each leaf's gradient against the plain run's: the norm of
            # the difference over the plain gradient's norm, floored at
            # 1e-3 of the largest leaf's (the key biases' true gradient
            # is 0: a softmax does not see a constant added to a
            # query's scores, so theirs is rounding alone)
            p_norms = [float(g.float().norm()) for g in p_grads]
            k_norms = [float(g.float().norm()) for g in k_grads]
            floor = 1e-3 * max(p_norms)
            rel = [float((a.float() - b.float()).norm()) / max(n, floor)
                   for a, b, n in zip(k_grads, p_grads, p_norms)]
            rel_norm = [abs(a - b) / max(b, floor)
                        for a, b in zip(k_norms, p_norms)]
            leaf_names = optim.tree_leaves(_paths(params))
            worst = sorted(zip(rel, leaf_names))[-3:]
            f64 = None
            trunk, trunk_rel = trunk_split(leaf_names, rel)
            if f32:
                f64 = beyond_float64(k_grads, p_grads, e_grads, skip=trunk)
                f64 = f64[:3] + ([(x, a, b, leaf_names[i])
                                  for x, a, b, i in f64[3]],)
            del p_grads, k_grads, e_grads
            held = f64[0] if f32 else max(rel_norm)
            require(not f32 or trunk_rel <= TRUNK_GRAD_TOL, "%s: a ResNet "
                    "leaf's gradient off by %.3g of its norm from the plain "
                    "run's (tol %g)" % (tag, trunk_rel, TRUNK_GRAD_TOL))
            require(all(np.isfinite(k_norms)) and held <= grad_tol
                    and abs(k_loss - p_loss) <= loss_tol * p_loss,
                    "%s: the first step's loss %.6f against the plain "
                    "run's %.6f (tol %g); a leaf's gradient off by %.3g "
                    "of its norm (the worst %s), its norm by %.3g; %s (tol "
                    "%g on the %s)"
                    % (tag, k_loss, p_loss, loss_tol, max(rel), worst,
                       max(rel_norm), "against float64 %.3g beyond the "
                       "plain float32 run's (kernels %.3g, plain %.3g; the "
                       "worst %s)" % f64 if f32 else "", grad_tol,
                       "excess over float64" if f32 else "second"))
            with holds.plain_versions():
                _, met_p = step(state0, batch, gen(), ss_prob, lr,
                                lr_cnn)
            plain_loss = float(met_p["loss"])
            t_parts.append(time.time())
            # n_timed steps through the kernels, from the same state
            st, g_run = state0, gen()
            want_launch = dict.fromkeys(counters, 0)
            for kn in ("fused_lstm_cell", "fused_lstm_cell_bwd",
                       "lstm_bwd_dxh", "lstm_bwd_dw"):
                want_launch[kn] = n_steps * len(vcells)
                want_launch[kn + "_" + route] = n_steps * len(vcells)
            want_shapes = {(kn, route, TRAIN_B, e): n_steps
                           for _, e in vcells
                           for kn in ("K2", "K2bwd", "K2dxh", "K2dw")}
            losses, times, encodes, shapes = [], [], [], []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(n_timed):
                shapes.clear()
                for c in counters.values():
                    c.n = 0
                enc0 = fused_lstm.map_encodes()
                t0 = time.perf_counter()
                with holds.recording_shapes(shapes):
                    st, met = step(st, batch, g_run, ss_prob, lr,
                                   lr_cnn)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                encodes.append(fused_lstm.map_encodes() - enc0)
                losses.append(float(met["loss"]))
                launches = {kn: c.n for kn, c in counters.items()}
                got = {}
                for shp in shapes:
                    got[shp] = got.get(shp, 0) + 1
                require(launches == want_launch and got == want_shapes,
                        "%s: launches %s, shapes %s; expected %s and %s"
                        % (tag, launches, got, want_launch, want_shapes))
            peak = torch.cuda.max_memory_allocated()
            require(all(np.isfinite(losses)) and
                    abs(losses[0] - plain_loss) <= loss_tol * plain_loss,
                    "%s: the first step's loss %.6f through the kernels, "
                    "%.6f through the plain versions (tol %g)"
                    % (tag, losses[0], plain_loss, loss_tol))
            require(losses[-1] < losses[0], "%s: the loss did not fall "
                    "over %d steps: %s" % (tag, n_timed, losses))
            t_parts.append(time.time())
            # one step with every K2 call held against its plain version;
            # float32: K2's error shared by the batch's rows (k2_bias)
            broken, held_shapes, bias = [], [], {}
            with k2_bias(torch, bias, on=f32), holds.held_calls(broken), \
                    holds.recording_shapes(held_shapes):
                step(st, batch, gen(), ss_prob, lr, lr_cnn)
            torch.cuda.synchronize()
            check_k2_bias(bias, tag)
            # each step of each cell: the forward, and the whole backward's
            # three launches
            n_held = 4 * n_steps * len(vcells)
            require(not broken and len(held_shapes) == n_held,
                    "%s: %d K2 calls broke their hold (first: %s), %d of "
                    "%d launched" % (tag, len(broken), broken[:1],
                                     len(held_shapes), n_held))
            t_med = sorted(times[1:])[len(times[1:]) // 2]
            res = dict(
                first_loss=losses[0], plain_first_loss=plain_loss,
                grad_max_rel_diff=max(rel), grad_worst_leaves=worst,
                grad_float64=None if f64 is None else dict(
                    excess=f64[0], kernels=f64[1], plain=f64[2],
                    worst=f64[3]),
                grad_norm_max_rel_diff=max(rel_norm),
                trunk_grad_max_rel_diff=trunk_rel, k2_bias=bias,
                grad_norm_total=sum(n * n for n in k_norms) ** 0.5,
                plain_grad_norm_total=sum(n * n for n in p_norms) ** 0.5,
                losses=losses,
                seconds=times, ms_per_step=t_med * 1e3,
                samples_per_s=TRAIN_B / t_med, peak_memory_gib=peak
                / 2 ** 30, map_encodes_per_step=encodes,
                launches_per_step=want_launch, k2_calls_held=n_held,
                tokens=float(met["tokens"]), fine_tune_scope=scope)
            log("%s: first loss %.6f (plain %.6f), every leaf's gradient "
                "within %.3g of the plain run's, its norm within %.3g "
                "(tol %g on the %s; worst %s)%s, gradient norm %.6g (plain "
                "%.6g); %d steps, losses %s; "
                "per step K2 forward %d and backward %d (each three "
                "launches) on %s at B=%d "
                "E=%s, every call of a further step held; %.2f ms a "
                "step (median of %d), %.1f samples/s, peak memory %.2f "
                "GiB, TMA map encodes a step %s"
                % (tag, losses[0], plain_loss, max(rel), max(rel_norm),
                   grad_tol, "excess over float64" if f32 else "norm",
                   worst, "; against float64 the kernels' %.3g, the plain "
                   "float32 run's %.3g, excess %.3g" % (f64[1], f64[2],
                                                        f64[0])
                   if f32 else "",
                   res["grad_norm_total"],
                   res["plain_grad_norm_total"], n_timed,
                   ["%.4f" % x for x in losses], n_steps * len(vcells),
                   n_steps * len(vcells), route, TRAIN_B,
                   [e for _, e in vcells], t_med * 1e3,
                   len(times) - 1, TRAIN_B / t_med, peak / 2 ** 30,
                   encodes))
            t_parts.append(time.time())
            if profiled is None or label in profiled:
                res["profile"] = profile_step(
                    torch, lambda: step(st, batch, gen(), ss_prob, lr,
                                        lr_cnn), tag,
                    XE_RANGES + ("xe:trunk",))
                require_no_products(res["profile"], tag)
                if pixels:
                    require_trunk_parts(res["profile"], tag, "xe:trunk")
            res["variant_seconds"] = part_seconds(t_parts, tag)
            out["%s/ss_%s" % (label, "on" if ss else "off")] = res
            for suffix, _ in vcells:
                credit_launches(
                    kernels, on_path, tag, n_steps * n_timed,
                    "fused_lstm_cell_bwd_%s%s/%s" % (route, suffix, dn),
                    "lstm_bwd_dxh_%s%s/%s" % (route, suffix, dn),
                    "lstm_bwd_dw_%s%s/%s" % (route, suffix, dn),
                    "fused_lstm_cell_%s_train%s/%s" % (route, suffix, dn))
    finally:
        del model.encode
        (decode.teacher_forced_logits, steps.label_smoothing_loss,
         steps.apply_updates_partitioned, resnet.apply) = saved[1:]
    return out


SCST_STEPS = 8                # SCST steps through the kernels per variant
SCST_NGRAMS = 1_300_000       # random idf keys (examples/bench_train.py)


def scst_data(torch, args, dev, vocab):
    """SCST's references and reward table (phases 15 and 16): R = 7
    references an image (TrainConfig.scst_num_refs), padded to 32
    (scst_max_ref_len), 6-20 ids each over ``vocab`` from a seeded numpy
    draw; the idf table holds their n-grams (document frequency over the
    batch's images) and SCST_NGRAMS random keys, as
    examples/bench_train.py's COCO-sized table, so that the rollouts'
    lookups both hit and miss; the references' norms are computed once, on
    the card, as a trainer ships them.  -> (table on the card, probe,
    ref_ids, ref_lens, ref_norms)."""
    import numpy as np
    from simpleimagecaptionzoo_tpu_torch.config import TrainConfig
    from simpleimagecaptionzoo_tpu_torch.ops import cider
    tc = TrainConfig()
    r, lr = tc.scst_num_refs, tc.scst_max_ref_len
    rng = np.random.default_rng(args.seed + 5)
    lens = rng.integers(6, 21, size=(TRAIN_B, r))
    ids = np.zeros((TRAIN_B, r, lr), np.int64)
    refs = []
    for i in range(TRAIN_B):
        refs.append([])
        for j in range(r):
            ids[i, j, :lens[i, j]] = rng.integers(4, vocab, lens[i, j])
            refs[-1].append(ids[i, j, :lens[i, j]].tolist())
    own = cider.CiderDTable.from_ref_corpus(refs)
    h = rng.integers(0, 2 ** 32, size=(2, SCST_NGRAMS), dtype=np.uint64)
    table = cider.CiderDTable(
        np.concatenate([own.h1, h[0].astype(np.uint32)]),
        np.concatenate([own.h2, h[1].astype(np.uint32)]),
        np.concatenate([own.df, rng.integers(1, 500, SCST_NGRAMS).astype(
            np.float32)]), float(np.log(113_287)))
    td = table.device_arrays(dev)
    ref_ids = torch.from_numpy(ids).to(dev)
    ref_lens = torch.from_numpy(lens).to(dev)
    norms = cider.ref_norms_device(td, table.probe, ref_ids, ref_lens)
    log("SCST references: B=%d, R=%d, padded to %d, lengths 6-20, %d own "
        "n-grams; idf table %d keys, probe %d, bucket bits %d"
        % (TRAIN_B, r, lr, len(own.h1), len(table.h1), table.probe,
           table.bucket_bits))
    return td, table.probe, ref_ids, ref_lens, norms


def _steps_taken(ids):
    """The greedy loop's steps for ids (B, MAX_LEN): it stops after the
    step where the last open row emitted <end>, or at the cap."""
    from simpleimagecaptionzoo_tpu_torch import END_ID
    ended = ids == END_ID
    if not bool(ended.any(dim=1).all()):
        return ids.shape[1]
    return int(ended.float().argmax(dim=1).max()) + 1


def drive_scst(torch, args, dev, model, params, kernels, on_path, data, *,
               name, cells, lr, variants, n_timed=SCST_STEPS, visual=None,
               model_state=None, lr_cnn=0.0, calls=None, init_cell=False,
               profiled=None, relu_replay=False):
    """SCST training through engine.steps.make_scst_train_step (phase 15:
    AoADetection at full width; phase 16: BUTDDetection), B=128 with 36
    valid boxes, cap MAX_LEN, the references and table of
    :func:`scst_data`, Adam at ``lr`` with the value clamp 0.25;
    ``variants``: (dtype name, compute dtype).  ``cells``: (entry suffix,
    width of x) of each LSTM cell a step runs.  In each variant:

    1. the first step against the plain versions: the kernel run's greedy
       baseline and rollout, then the plain versions' greedy baseline
       (its ids against the kernel run's: 99 % of rows in float32, 99 % of
       first ids in bf16) and a replay of the kernel run's rollout and
       baseline ids through the plain versions: the rewards identical
       (the same ids), some nonzero; the loss within 1e-5 (float32) or
       1e-2 (bf16) of sum |logp| |reward| over the mask; each leaf's
       gradient as phase 14 holds it;
    2. ``n_timed`` steps through the kernels: per step K1 once a greedy
       step taken (at m=128, k=1), K2's forward that many plus MAX_LEN
       times per cell and its backward MAX_LEN times per cell, every
       launch on the dtype's tensor-core route at its shape, exactly; the
       loss and reward finite; ms a step, samples/s, peak memory;
    3. one step with every K1, K2 and K2-backward call held against its
       plain version (engine/holds.held_calls);
    4. one step under torch.profiler, by part (SCST_RANGES).

    From pixels (phase 20), ``visual``, ``model_state`` and ``lr_cnn`` as
    in :func:`drive_xe` (the fine-tune scope checked on the first step,
    the trunk's forward as "scst:trunk" in the profile); ``calls`` (a
    KernelCalls) records the timed steps' K1 launches for entries of
    their own (K1 at a head other than phase 3's ``_train`` entry's).
    ``init_cell``: the family runs its cell once more before each decode
    (NIC's step -1 cell): one more K2 forward in the greedy baseline, one
    more forward and whole backward in the rollout.  ``profiled``: the
    dtype names of the variants profiled (all when None).
    ``relu_replay``: the float32 first step's plain and float64 runs take
    the kernel run's ReLU branches (:func:`relu_branches`; BUTDSpatial
    from pixels, whose float32 gate failed without it)."""
    import numpy as np
    from torch.profiler import record_function
    from simpleimagecaptionzoo_tpu_torch.engine import holds, optim, steps
    from simpleimagecaptionzoo_tpu_torch.engine.state import TrainState
    from simpleimagecaptionzoo_tpu_torch.ops import (decode, fused_head,
                                                     fused_lstm)
    td, probe, ref_ids, ref_lens, ref_norms = data
    g0 = torch.Generator(device=dev).manual_seed(args.seed + 3)
    if visual is None:
        visual = {
            "bu_feats": torch.relu(torch.randn(
                TRAIN_B, N_BOX, model.config.enc_dim, generator=g0,
                device=dev)),
            "bu_masks": torch.ones(TRAIN_B, N_BOX, device=dev)}
    batch = {"visual": visual, "ref_ids": ref_ids, "ref_lens": ref_lens,
             "ref_norms": ref_norms}
    ms0 = {} if model_state is None else model_state
    pixels = "img_tensors" in visual
    ic = 1 if init_cell else 0
    labels = model.param_labels(params)
    counters = dict(fused_head_topk=fused_head.COUNT,
                    fused_head_topk_wgmma=fused_head.COUNT_WGMMA,
                    fused_head_topk_tf32x3=fused_head.COUNT_TF32X3,
                    fused_lstm_cell=fused_lstm.COUNT,
                    fused_lstm_cell_wgmma=fused_lstm.COUNT_WGMMA,
                    fused_lstm_cell_tf32x3=fused_lstm.COUNT_TF32X3,
                    fused_lstm_cell_bwd=fused_lstm.COUNT_BWD,
                    fused_lstm_cell_bwd_wgmma=fused_lstm.COUNT_BWD_WGMMA,
                    fused_lstm_cell_bwd_tf32x3=fused_lstm.COUNT_BWD_TF32X3,
                    **k2_product_counters(fused_lstm))

    def gen():
        return torch.Generator(device=dev).manual_seed(args.seed + 4)

    def ranged(rname, fn, keep=None):
        def run(*a, **kw):
            with record_function(rname):
                out = fn(*a, **kw)
            if keep is not None:
                keep[:] = [a, out]
            return out
        return run

    baseline, criterion = [], []
    predict = model.predict

    def head(params_, hidden):
        # the hoisted head over (B, T, H); a rollout step's (B, H) head
        # stays in the rollout's range
        if hidden.dim() == 3:
            with record_function("scst:hoisted_head"):
                return predict(params_, hidden)
        return predict(params_, hidden)

    from simpleimagecaptionzoo_tpu_torch.models import resnet
    saved = (steps.greedy_baseline, decode.sample_rl, decode._token_logprobs,
             steps.self_critical_reward, steps.reward_criterion,
             steps.apply_updates_partitioned, resnet.apply)
    resnet.apply = ranged("scst:trunk", saved[6])
    model.encode = ranged("scst:encode", model.encode)
    model.predict = head
    steps.greedy_baseline = ranged("scst:greedy_baseline", saved[0],
                                   baseline)
    decode.sample_rl = ranged("scst:rollout", saved[1])
    decode._token_logprobs = ranged("scst:hoisted_head", saved[2])
    steps.self_critical_reward = ranged("scst:reward", saved[3])
    steps.reward_criterion = ranged("scst:loss", saved[4], criterion)
    steps.apply_updates_partitioned = ranged("scst:optimizer", saved[5])
    out = {}
    try:
        for label, cdtype in variants:
            dn = label
            route = "tf32x3" if cdtype is None else "wgmma"
            f32 = cdtype is None
            # the holds of phase 14's first step (the loss's against its
            # own scale here: an SCST loss is a signed sum)
            loss_tol, grad_tol = (1e-5, 1e-4) if f32 else (1e-2, 2e-2)
            t_parts = [time.time()]
            tag = "scst %s %s" % (name, label)
            adam = optim.make_grad_transform("Adam", 0.25)
            tx = optim.GradientTransformation(
                adam.init, ranged("scst:optimizer", adam.update))
            step = steps.make_scst_train_step(
                model, tx, labels, td, probe, max_len=MAX_LEN,
                compute_dtype=cdtype, device="cuda")
            state0 = TrainState.create(params, tx, ms0)

            def loss_grads(greedy_seq, replay=None, dtype=cdtype):
                leaves = [p.detach().requires_grad_()
                          for p in optim.tree_leaves(params)]
                loss, reward, _, seq, drawn = steps.scst_loss(
                    model, steps._stop_cnn_grads(
                        optim.tree_unflatten(params, leaves), False), ms0,
                    batch, td, probe, greedy_seq, gen(),
                    steps.draw_generator_for(gen(), 0, dev), max_len=MAX_LEN,
                    compute_dtype=dtype, replay=replay)
                logp, seq_, reward_ = criterion[0][:3]
                scale = float(steps.reward_criterion(
                    -logp.detach().abs(), seq_, reward_.abs()))
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
                return (float(loss.detach()), reward.detach(), seq, drawn,
                        [torch.zeros_like(p) if g is None else g
                         for p, g in zip(leaves, grads)], scale)

            # 1. the first step: the kernels, then the plain versions on the
            # kernel run's ids
            g_k = steps.greedy_baseline(model, params, ms0, batch["visual"],
                                        MAX_LEN, cdtype)
            # with relu_replay (float32), the kernel run's ReLU branches
            # kept for the replays (relu_branches)
            replay_on = f32 and relu_replay
            masks, flips = [], []
            with relu_branches(torch, masks, on=replay_on):
                k_loss, k_reward, seq_k, drawn_k, k_grads, _ = loss_grads(
                    g_k)
            scope = (check_fine_tune_scope(params, k_grads, tag) if pixels
                     else None)
            with holds.plain_versions():
                g_p = steps.greedy_baseline(model, params, ms0,
                                            batch["visual"], MAX_LEN, cdtype)
                with relu_branches(torch, masks, flips, on=replay_on):
                    p_loss, p_reward, _, _, p_grads, scale = loss_grads(
                        g_k, replay=(seq_k, drawn_k))
                # float32: the same replay in float64 (beyond_float64)
                if f32:
                    with relu_branches(torch, masks, flips, on=replay_on):
                        e_grads = loss_grads(g_k, replay=(seq_k, drawn_k),
                                             dtype=torch.float64)[4]
                else:
                    e_grads = None
            relu_flips = check_flips(flips, tag) if replay_on else None
            rows_same = float((g_k == g_p).all(dim=1).float().mean())
            first_same = float((g_k[:, 0] == g_p[:, 0]).float().mean())
            p_norms = [float(g.float().norm()) for g in p_grads]
            k_norms = [float(g.float().norm()) for g in k_grads]
            floor = 1e-3 * max(p_norms)
            rel = [float((a.float() - b.float()).norm()) / max(n, floor)
                   for a, b, n in zip(k_grads, p_grads, p_norms)]
            rel_norm = [abs(a - b) / max(b, floor)
                        for a, b in zip(k_norms, p_norms)]
            leaf_names = optim.tree_leaves(_paths(params))
            worst = sorted(zip(rel, leaf_names))[-3:]
            f64 = None
            trunk, trunk_rel = trunk_split(leaf_names, rel)
            if f32:
                f64 = beyond_float64(k_grads, p_grads, e_grads, skip=trunk)
                f64 = f64[:3] + ([(x, a, b, leaf_names[i])
                                  for x, a, b, i in f64[3]],)
            del p_grads, k_grads, e_grads
            held = f64[0] if f32 else max(rel_norm)
            require(not f32 or trunk_rel <= TRUNK_GRAD_TOL, "%s: a ResNet "
                    "leaf's gradient off by %.3g of its norm from the plain "
                    "run's (tol %g)" % (tag, trunk_rel, TRUNK_GRAD_TOL))
            n_rewarded = int((k_reward != 0).sum())
            require(torch.equal(k_reward, p_reward) and n_rewarded > 0,
                    "%s: the rewards of the same ids differ (max %.3g) or "
                    "are all 0 (%d nonzero)"
                    % (tag, float((k_reward - p_reward).abs().max()),
                       n_rewarded))
            require((rows_same if f32 else first_same) >= 0.99,
                    "%s: the greedy baseline's %s identical to the plain "
                    "run's: %.4f (gate 0.99)"
                    % (tag, "rows" if f32 else "first ids",
                       rows_same if f32 else first_same))
            require(all(np.isfinite(k_norms)) and held <= grad_tol
                    and abs(k_loss - p_loss) <= loss_tol * scale,
                    "%s: the first step's loss %.6g against the plain "
                    "replay's %.6g (tol %g of its scale %.4g); a leaf's "
                    "gradient off by %.3g of its norm (the worst %s), its "
                    "norm by %.3g; %s (tol %g on the %s)"
                    % (tag, k_loss, p_loss, loss_tol, scale, max(rel),
                       worst, max(rel_norm), "against float64 %.3g beyond "
                       "the plain float32 run's (kernels %.3g, plain %.3g; "
                       "the worst %s)" % f64 if f32 else "", grad_tol,
                       "excess over float64" if f32 else "second"))
            log("%s: first step through the kernels: loss %.6g (the plain "
                "replay's %.6g, scale %.4g), mean reward %.5g, %d of %d "
                "rewards nonzero and identical to the replay's; every "
                "leaf's gradient within %.3g of the plain run's, its norm "
                "within %.3g (tol %g on the %s; worst %s)%s; greedy "
                "baseline against the plain versions' rows %.4f, first ids "
                "%.4f"
                % (tag, k_loss, p_loss, scale, float(k_reward.mean()),
                   n_rewarded, TRAIN_B, max(rel), max(rel_norm), grad_tol,
                   "excess over float64" if f32 else "norm", worst,
                   "; against float64 the kernels' %.3g, the plain float32 "
                   "run's %.3g, excess %.3g" % (f64[1], f64[2], f64[0])
                   if f32 else "", rows_same, first_same))
            if relu_flips is not None:
                log("%s: the replays on the kernel run's ReLU branches: %d "
                    "branches differ, the largest at %.3g of its tensor's "
                    "largest |x| (tol %g)" % (tag, relu_flips[0],
                                             relu_flips[1], FLIP_TOL))
            t_parts.append(time.time())
            # 2. n_timed steps through the kernels
            st, g_run = state0, gen()
            losses, rewards, times, encodes, taken = [], [], [], [], []
            shapes = []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(n_timed):
                shapes.clear()
                for c in counters.values():
                    c.n = 0
                enc0 = fused_lstm.map_encodes()
                recording = (contextlib.nullcontext() if calls is None
                             else calls.recording(torch))
                t0 = time.perf_counter()
                with recording, holds.recording_shapes(shapes):
                    st, met = step(st, batch, g_run, lr, lr_cnn)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                encodes.append(fused_lstm.map_encodes() - enc0)
                losses.append(float(met["loss"]))
                rewards.append(float(met["reward"]))
                n_g = _steps_taken(baseline[1])
                taken.append(n_g)
                nc = len(cells)
                fwd = nc * (n_g + MAX_LEN) + 2 * ic
                bwd = nc * MAX_LEN + ic
                want = {"fused_head_topk": n_g,
                        "fused_head_topk_" + route: n_g,
                        "fused_lstm_cell": fwd,
                        "fused_lstm_cell_" + route: fwd,
                        "fused_lstm_cell_bwd": bwd,
                        "fused_lstm_cell_bwd_" + route: bwd,
                        "lstm_bwd_dxh": bwd,
                        "lstm_bwd_dxh_" + route: bwd,
                        "lstm_bwd_dw": bwd,
                        "lstm_bwd_dw_" + route: bwd}
                want = {kn: want.get(kn, 0) for kn in counters}
                want_shapes = {("K1", route, TRAIN_B, 1): n_g}
                for _, e in cells:
                    want_shapes[("K2", route, TRAIN_B, e)] = (
                        n_g + MAX_LEN + 2 * ic)
                    for kn in ("K2bwd", "K2dxh", "K2dw"):
                        want_shapes[(kn, route, TRAIN_B, e)] = MAX_LEN + ic
                launches = {kn: c.n for kn, c in counters.items()}
                got = {}
                for shp in shapes:
                    got[shp] = got.get(shp, 0) + 1
                require(launches == want and got == want_shapes,
                        "%s: launches %s, shapes %s; expected %s and %s "
                        "(%d greedy steps)" % (tag, launches, got, want,
                                               want_shapes, n_g))
            peak = torch.cuda.max_memory_allocated()
            require(all(np.isfinite(losses)) and all(np.isfinite(rewards)),
                    "%s: losses %s, rewards %s" % (tag, losses, rewards))
            t_parts.append(time.time())
            # 3. one step with every kernel call held; float32: K2's error
            # shared by the batch's rows (k2_bias)
            broken, held_shapes, bias = [], [], {}
            with k2_bias(torch, bias, on=f32), holds.held_calls(broken), \
                    holds.recording_shapes(held_shapes):
                step(st, batch, gen(), lr, lr_cnn)
            torch.cuda.synchronize()
            check_k2_bias(bias, tag)
            n_g = _steps_taken(baseline[1])
            # K1 a greedy step; per cell K2's forward a greedy and a
            # rollout step, and the whole backward's three launches a
            # rollout step
            n_held = n_g + len(cells) * (n_g + 4 * MAX_LEN) + 5 * ic
            require(not broken and len(held_shapes) == n_held,
                    "%s: %d kernel calls broke their hold (first: %s), %d "
                    "of %d launched" % (tag, len(broken), broken[:1],
                                        len(held_shapes), n_held))
            t_med = sorted(times[1:])[len(times[1:]) // 2]
            res = dict(
                first_loss=k_loss, plain_first_loss=p_loss,
                loss_scale=scale, first_rewards_nonzero=n_rewarded,
                first_mean_reward=float(k_reward.mean()),
                greedy_rows_identical=rows_same,
                grad_float64=None if f64 is None else dict(
                    excess=f64[0], kernels=f64[1], plain=f64[2],
                    worst=f64[3]),
                greedy_first_ids_identical=first_same,
                grad_max_rel_diff=max(rel), grad_worst_leaves=worst,
                grad_norm_max_rel_diff=max(rel_norm),
                trunk_grad_max_rel_diff=trunk_rel, k2_bias=bias,
                relu_flips=relu_flips,
                grad_norm_total=sum(n * n for n in k_norms) ** 0.5,
                plain_grad_norm_total=sum(n * n for n in p_norms) ** 0.5,
                losses=losses, rewards=rewards, greedy_steps=taken,
                seconds=times, ms_per_step=t_med * 1e3,
                samples_per_s=TRAIN_B / t_med,
                peak_memory_gib=peak / 2 ** 30, map_encodes_per_step=encodes,
                launches_last_step=want, kernel_calls_held=n_held,
                fine_tune_scope=scope)
            log("%s: %d steps, losses %s, mean rewards %s, greedy steps %s; "
                "per step K1 once a greedy step, K2 forward (greedy steps + "
                "%d) x %d and backward %d x %d (three launches each) on %s "
                "at B=%d E=%s, exactly; "
                "every call of a further step held (%d); %.2f ms a step "
                "(median of %d), %.1f samples/s, peak memory %.2f GiB, TMA "
                "map encodes a step %s"
                % (tag, n_timed, ["%.5g" % x for x in losses],
                   ["%.5g" % x for x in rewards], taken, MAX_LEN, len(cells),
                   MAX_LEN, len(cells), route, TRAIN_B,
                   [e for _, e in cells], n_held, t_med * 1e3,
                   len(times) - 1, TRAIN_B / t_med, peak / 2 ** 30, encodes))
            t_parts.append(time.time())
            if profiled is None or label in profiled:
                res["profile"] = profile_step(
                    torch, lambda: step(st, batch, gen(), lr, lr_cnn), tag,
                    SCST_RANGES + ("scst:trunk",))
                require_no_products(res["profile"], tag)
                if pixels:
                    require_trunk_parts(res["profile"], tag, "scst:trunk")
            res["variant_seconds"] = part_seconds(t_parts, tag)
            out[label] = res
            if calls is None:
                credit_launches(kernels, on_path, tag, sum(taken),
                                "fused_head_topk_%s_train/%s" % (route, dn))
            for suffix, _ in cells:
                credit_launches(
                    kernels, on_path, tag,
                    sum(taken) + (MAX_LEN + 2 * ic) * n_timed,
                    "fused_lstm_cell_%s_train%s/%s" % (route, suffix, dn))
                credit_launches(
                    kernels, on_path, tag, (MAX_LEN + ic) * n_timed,
                    "fused_lstm_cell_bwd_%s%s/%s" % (route, suffix, dn),
                    "lstm_bwd_dxh_%s%s/%s" % (route, suffix, dn),
                    "lstm_bwd_dw_%s%s/%s" % (route, suffix, dn))
    finally:
        del model.encode, model.predict
        (steps.greedy_baseline, decode.sample_rl, decode._token_logprobs,
         steps.self_critical_reward, steps.reward_criterion,
         steps.apply_updates_partitioned, resnet.apply) = saved
    return out


# -- phase 18: the CLI on the card --------------------------------------------
CLI_VOCAB = 10102             # bench.py's production head
CLI_SPLITS = (("train", 512), ("val", 128), ("test", 128))    # AoADetection
NIC_SPLITS = (("train", 256), ("val", 64), ("test", 64))      # NIC, pixels
CLI_B, CLI_EVAL_B, CLI_SIDE = 128, 64, 224
CLI_PHASE_S = 90.0            # phase 18's share of the script's time limit
CLI_BARE_STEPS = 4            # the bare replay of a training op's first step
# the ops whose first decode batch (NIC's first XE step) is replayed with
# every kernel call held
CLI_HELD_OPS = ("eval_float32", "eval_bfloat16", "eval_int8", "nic_eval",
                "nic_train")


def write_vocab(root):
    """Phase 18's vocabulary (also phase 19's): CLI_VOCAB entries, the four
    specials and the words w0, w1, ..., in Data/caption_vocab.pkl under
    ``root``, with Configs/Datasets/ made beside it.  -> the words."""
    from simpleimagecaptionzoo_tpu_torch.vocab import build_vocab, save_vocab
    words = ["w%d" % i for i in range(CLI_VOCAB - 4)]
    os.makedirs(os.path.join(root, "Data"), exist_ok=True)
    os.makedirs(os.path.join(root, "Configs", "Datasets"), exist_ok=True)
    vocab = build_vocab([words], threshold=1)
    require(len(vocab) == CLI_VOCAB, "the vocabulary holds %d entries"
            % len(vocab))
    save_vocab(vocab, os.path.join(root, "Data", "caption_vocab.pkl"))
    return words


def write_cli_dataset(torch, root, seed, dev):
    """Phase 18's dataset in the reference layout under ``root``, from
    ``seed``: a vocabulary of CLI_VOCAB entries (Data/caption_vocab.pkl),
    one caption of 8-16 words drawn from it per image, word i with
    probability proportional to (i + 1)^-1.1 (captions' words are Zipfian,
    so the commonest word outdraws <end> and a briefly trained model's
    greedy and beam decodes run to their caps); Flickr8K (the
    AoADetection run: CLI_SPLITS images, Data/fixed_bu_feat/<id>.npz with
    36 x 2048 float32 features and Data/fixed_bu_bbox/<id>.npy boxes) and
    Flickr30K (the NIC run: NIC_SPLITS images as one packed uint8 shard at
    224, Data/images_224_packed.npy, the layout of
    preprocess/pack_images.py), each with its Configs/Datasets/<ds>.data
    and modified_annotations/<prefix>captions_<split>.json."""
    import numpy as np
    rng = np.random.default_rng(seed + 18)
    words = write_vocab(root)
    zipf = 1.0 / np.arange(1, len(words) + 1) ** 1.1
    zipf /= zipf.sum()
    data = os.path.join(root, "Data")
    for d in ("fixed_bu_feat", "fixed_bu_bbox"):
        os.makedirs(os.path.join(data, d))
    os.makedirs(os.path.join(root, "modified_annotations"))

    def splits(dataset, prefix, sizes, first, name):
        ids, nid = {}, first
        for split, n in sizes:
            images, anns = [], []
            for i in range(nid, nid + n):
                toks = [words[j] for j in rng.choice(
                    len(words), int(rng.integers(8, 17)), p=zipf)]
                cap = " ".join(toks)
                anns.append({"image_id": i, "id": i, "caption": cap,
                             "tokens": toks, "file_name": name % i})
                images.append({"id": i, "file_name": name % i,
                               "sentids": [i], "sentences": [
                                   {"tokens": toks, "raw": cap}]})
            with open(os.path.join(root, "modified_annotations",
                                   "%scaptions_%s.json" % (prefix, split)),
                      "w") as f:
                json.dump({"images": images, "annotations": anns}, f)
            ids[split] = list(range(nid, nid + n))
            nid += n
        with open(os.path.join(root, "Configs", "Datasets",
                               dataset + ".data"), "w") as f:
            f.write("image_root=/images/\n" + "".join(
                "%s_caption_path=/modified_annotations/%scaptions_%s.json\n"
                % (s, prefix, s) for s, _ in sizes)
                + "data_dir=/Data/\ncaption_vocab_path=/Data/"
                  "caption_vocab.pkl\n")
        return ids

    aoa = splits("Flickr8K", "", CLI_SPLITS, 0, "img_%d.jpg")
    nic = splits("Flickr30K", "nic_", NIC_SPLITS, 10_000, "nic_%d.jpg")
    for i in (i for v in aoa.values() for i in v):
        np.savez(os.path.join(data, "fixed_bu_feat", "%d.npz" % i),
                 feat=np.abs(rng.standard_normal((N_BOX, 2048),
                                                 dtype=np.float32)))
        xy = rng.uniform(0, 400, (N_BOX, 2)).astype(np.float32)
        np.save(os.path.join(data, "fixed_bu_bbox", "%d.npy" % i),
                np.concatenate([xy, xy + rng.uniform(
                    8, 200, (N_BOX, 2)).astype(np.float32)], 1))
    names = ["nic_%d.jpg" % i for v in nic.values() for i in v]
    gen = torch.Generator(device=dev).manual_seed(seed + 18)
    np.save(os.path.join(data, "images_%d_packed.npy" % CLI_SIDE),
            photo_batch(torch, gen, len(names), CLI_SIDE, dev).cpu().numpy())
    with open(os.path.join(data, "images_%d_index.json" % CLI_SIDE),
              "w") as f:
        json.dump({"order": names, "size": CLI_SIDE}, f)
    return aoa, nic


class KernelCalls:
    """Phase 18's record of every kernel launch, by (kernel, route, rows,
    the width of x or k, x's dtype, what else fixes the shape): how often
    each launched, and the wrapper's arguments at its CAPTURE_AT-th launch
    (or its last, if fewer), so that the kernel can be held and timed
    afterwards on inputs the path gave it (K2's whole backward, three
    launches a call, by its first: the backward kernel's).  The 21st
    launch: an XE step
    runs each cell 21 times, so K2's backward is held at t=0, where every
    row's cotangent is live, and not at the last step, where the rows that
    ended are zero.  Tensors below 4M elements are cloned; larger ones (the
    weights, which steps replace and never modify) are kept by
    reference."""

    CAPTURE_AT = 21

    def __init__(self):
        from simpleimagecaptionzoo_tpu_torch.ops import (fused_head,
                                                         fused_lstm,
                                                         int8_attention,
                                                         quant)
        self.wrappers = (("K1", fused_head, "topk_head"),
                         ("K2", fused_lstm, "lstm_cell_fused"),
                         ("K2bwd", fused_lstm, "lstm_cell_bwd_full"),
                         ("K3", quant, "quant_matmul"),
                         ("K4", int8_attention, "lanes_attention_int8"))
        self.shapes, self.first, self.count = [], {}, {}
        self._paused = False

    @contextlib.contextmanager
    def paused(self):
        """Launches in the block are not the path's (comparisons)."""
        self._paused = True
        try:
            yield
        finally:
            self._paused = False

    @staticmethod
    def _key(kind, shape, a, kw):
        _, route, rows, last = shape
        x = a[0] if kind in ("K3", "K4") else a[1] if kind == "K1" else a[2]
        # K2 and its backward: H, and the gate term's lanes (0: no term)
        lanes = 0 if kw.get("term") is None else kw.get("lanes", 1)
        extra = {"K1": lambda: (x.shape[1], a[0].v,
                                str(a[0].w.dtype) == "torch.int8"),
                 "K2": lambda: (a[3].shape[1], lanes),
                 "K2bwd": lambda: (a[3].shape[1], lanes),
                 "K3": lambda: (a[1]["s"].shape[0],),
                 "K4": lambda: (a[1].shape[1], x.shape[2], a[6])}[kind]()
        return (kind, route, rows, last, str(x.dtype).split(".")[1]) + extra

    @contextlib.contextmanager
    def recording(self, torch):
        from simpleimagecaptionzoo_tpu_torch.engine import holds

        def clone(v):
            if isinstance(v, torch.Tensor) and v.numel() < 1 << 22:
                return v.detach().clone()
            return v

        def wrap(kind, run):
            def fn(*a, **kw):
                if self._paused:
                    return run(*a, **kw)
                n = len(self.shapes)
                out = run(*a, **kw)
                if len(self.shapes) > n:           # it launched its kernels
                    key = self._key(kind, self.shapes[n], a, kw)
                    self.count[key] = self.count.get(key, 0) + 1
                    if self.count[key] <= self.CAPTURE_AT:
                        self.first[key] = (run, [clone(v) for v in a], kw)
                return out
            return fn

        saved = [(mod, name, getattr(mod, name))
                 for _, mod, name in self.wrappers]
        with holds.recording_shapes(self.shapes):
            for (kind, _, _), (mod, name, run) in zip(self.wrappers, saved):
                setattr(mod, name, wrap(kind, run))
            try:
                yield self
            finally:
                for mod, name, run in saved:
                    setattr(mod, name, run)


def cli_kernel_entries(torch, calls, kernels, on_path, flush, tag,
                       where="cli", phase="phase 18", kinds=None):
    """An entry of the kernels line for every shape phase 18 launched (or
    another path recorded in ``calls``; ``kinds``, when given, the kinds
    of kernel to make entries for): the
    kernel held against its plain version (engine/holds' hold) on the
    arguments KernelCalls kept, timed beside the plain version
    and, for K2 and K3, the library call that computes the same function
    (torch.lstm_cell, torch._weight_int8pack_mm); its bound; its launches
    in the run (K2's whole backward: cli_k2_bwd_entries).  Named
    <kernel>_<route>_<where>_<shape>/<dtype> (phase 18: ``cli``; phase 19:
    ``serve``; phase 20: ``px_train``)."""
    from simpleimagecaptionzoo_tpu_torch.engine import holds
    from simpleimagecaptionzoo_tpu_torch.ops import fused_head
    plain_of = {name: plain for _, name, plain in holds.plain_swaps()}
    rate_of = {"wgmma": "bfloat16", "tf32x3": "tf32x3", "tf32x2": "tf32x2",
               "tma": "float32"}
    src = "simpleimagecaptionzoo_tpu_torch/csrc/"
    made = []
    for key in sorted(calls.first, key=str):
        run, a, kw = calls.first[key]
        kind, route, rows, last, dn = key[:5]
        if kinds is not None and kind not in kinds:
            continue
        if kind == "K2bwd":
            made += cli_k2_bwd_entries(torch, run, a, kw, key,
                                       calls.count[key], kernels, on_path,
                                       flush, tag, where, phase)
            continue
        name = dict((k, n) for k, _, n in calls.wrappers)[kind]
        plain = plain_of[name]
        got = run(*a, **kw)
        want = plain(*a, **kw)
        torch.cuda.synchronize()
        why = holds._HOLDS[name](plain, a, kw, got)
        require(not why, "%s %s: the kernel breaks its hold on the "
                "path's own inputs: %s" % (phase, str(key), why))
        item = a[0 if kind in ("K3", "K4") else 1 if kind == "K1"
                 else 2].element_size()
        lib, extra = None, {}
        if kind == "K1":
            head, x, k = a[0], a[1], a[2]
            hd, v, int8 = key[5:]
            err = max(float((got[0] - want[0]).abs().max()),
                      float((got[2] - want[2]).abs().max()))
            nbytes = (rows * hd * item + hd * v * head.w.element_size()
                      + 2 * v * 4 + rows * (k * 8 + 4))
            nops = 2 * rows * hd * v
            w_x = ((head.w[:hd].float() * head.s).to(x.dtype) if int8
                   else head.w[:hd])
            extra["product_ms"] = time_ms(torch, lambda: x @ w_x, flush)
            ename = "fused_head_topk%s_%s_%s_m%dk%dH%d" % (
                "_int8" if int8 else "", route, where, rows, k, hd)
            shape = "m=%d K=%d V=%d%s k=%d" % (rows, hd, v,
                                                " int8 W" if int8 else "", k)
            files = ("fused_head.cu", "ops/fused_head.py:155")
        elif kind == "K2":
            w_cat, b_sum, x, h, c = a[:5]
            e, hd = x.shape[1], h.shape[1]
            lanes = key[6]
            require(w_cat.shape == (e + hd, 4 * hd), "%s: K2's w_cat %s at "
                    "E=%d H=%d" % (phase, tuple(w_cat.shape), e, hd))
            outs = [(got[i].float() - want[i].float()).abs().max()
                    for i in range(2)]
            err = float(max(outs))
            nbytes, nops = k2_fwd_size(rows, e, hd, item, lanes)
            lib = k2_library(torch, w_cat, b_sum, x, h, c, kw.get("term"),
                             max(lanes, 1))
            tsfx = "" if not lanes else "_term" + (
                "" if lanes == 1 else "x%d" % lanes)
            ename = "fused_lstm_cell_%s_%s_B%dE%dH%d%s" % (
                route, where, rows, e, hd, tsfx)
            files = ("fused_lstm.cu", "ops/pallas_lstm.py:166")
            shape = "B=%d E=%d H=%d%s" % (
                rows, e, hd, "" if not lanes
                else " with a gate term (lanes %d)" % lanes)
        elif kind == "K3":
            x, qp = a[0], a[1]
            x2 = x.reshape(-1, x.shape[-1])
            kk, n = x2.shape[1], key[5]
            err = float((got.float() - want.float()).abs().max())
            nbytes = rows * kk * item + kk * n + 2 * n * 4 + rows * n * item
            nops = 2 * rows * kk * n
            q_t = qp["q"][:kk, :n].t().contiguous()
            s_x = qp["s"].to(x.dtype)
            lib = lambda: torch._weight_int8pack_mm(x2, q_t, s_x)  # noqa
            ename = "quant_matmul_%s_%s_m%dK%dn%d" % (route, where, rows, kk,
                                                    n)
            shape = "m=%d K=%d n=%d" % (rows, kk, n)
            files = ("quant_matmul.cu", "ops/quant.py:105")
        else:
            q = a[0]
            nb, k, n, hd, heads = rows, last, key[5], key[6], key[7]
            err = max(float((got[0].float() - want[0].float()).abs().max()),
                      float((got[1] - want[1]).abs().max()))
            nbytes = (2 * nb * k * hd * item + 2 * nb * n * hd
                      + 3 * nb * n * 4 + nb * k * n * 4)
            nops = 4 * nb * k * n * hd
            ename = "int8_attention_%s_%s_B%dk%dN%d" % (route, where, nb, k,
                                                      n)
            shape = "B=%d k=%d N=%d D=%d heads=%d" % (nb, k, n, hd, heads)
            files = ("int8_attention.cu", "ops/int8_attention.py:70")
        ms = time_ms(torch, lambda: run(*a, **kw), flush)
        device_ms = time_ms(torch, lambda: run(*a, **kw), flush,
                            lead=DEVICE_LEAD)
        plain_ms = time_ms(torch, lambda: plain(*a, **kw), flush)
        lib_ms = None if lib is None else time_ms(torch, lib, flush)
        b_ms, b_by = bound(nbytes, nops, rate_of.get(route, dn))
        full = "%s/%s" % (ename, dn)
        kernels[full] = dict(
            name=full, route="cuda", source=src + files[0],
            replaces="simpleimagecaptionzoo_tpu/" + files[1],
            launches=0, max_abs_err=err, max_err=err, ms=ms, kernel_ms=ms,
            device_ms=device_ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms, kernel_route=route,
            shape=shape + " (%s, the path's own inputs)" % phase, **extra)
        credit_launches(kernels, on_path, tag, calls.count[key], full)
        made.append(full)
        log("%s %s %s (%s) %s: %d launches, held (max|err| %.3g); "
            "%.4f ms (device alone %.4f), plain %.4f, library %s, bound "
            "%.4f ms (%s)" % (phase, kind, dn, route, shape,
                              calls.count[key], err,
                              ms, device_ms, plain_ms,
                              "none" if lib_ms is None else "%.4f ms"
                              % lib_ms, b_ms, b_by))
    return made


def cli_k2_bwd_entries(torch, run, a, kw, key, count, kernels, on_path,
                       flush, tag, where="cli", phase="phase 18",
                       name_of=None):
    """Phase 18's entries for K2's whole backward at one shape the CLI ran
    (its first call's arguments, KernelCalls): the whole backward held on
    them (holds.k2_bwd_full_errors), then each of its three kernels (the
    backward kernel writing the products' operands, dx·dh, dW·db) on them,
    against its plain version, timed (host-inclusive and device-only)
    beside that plain version and its bound; the backward kernel's entry
    also carries the whole backward's time, its bound and torch.lstm_cell's
    backward through autograd.  Named <kernel>_<route>_<where>_B<B>E<E>H<H>,
    or ``name_of(<kernel>)`` (phase 22: the names the paths credited);
    an entry that exists keeps its launches."""
    from simpleimagecaptionzoo_tpu_torch.engine import holds
    from simpleimagecaptionzoo_tpu_torch.ops import fused_lstm
    _, route, rows, _, dn = key[:5]
    w_cat, b_sum, x, h, c, dh, dc = a[:7]
    split = a[7] if len(a) > 7 else kw.get("split")
    term, lanes = kw.get("term"), kw.get("lanes", 1)
    tkw = dict(term=term, lanes=lanes)
    e, hd = x.shape[1], h.shape[1]
    got = run(*a, **kw)
    torch.cuda.synchronize()
    ferr = holds.k2_bwd_full_errors(a, got, term, lanes)
    require(not max(ferr.values()), "%s %s: K2's whole backward "
            "breaks its hold on the path's own inputs: %s" % (phase, str(key),
                                                              ferr))
    want = fused_lstm.lstm_cell_bwd_full_plain(*a[:7], **tkw)
    g = fused_lstm._run_bwd_kernel(*a[:7], route, split, parts=True,
                                   **tkw)[0]
    dx, dhh = fused_lstm._run_dxh_kernel(w_cat, g, x, h, route)
    dw, db = fused_lstm._run_dw_kernel(x, h, g, w_cat, b_sum, route)
    d_plain = fused_lstm.lstm_cell_bwd_plain(*a[:7], **tkw)[0]
    pdx, pdh = fused_lstm.lstm_bwd_dxh_plain(w_cat, g.d, e)
    pdw, pdb = fused_lstm.lstm_bwd_dw_plain(x, h, g.d)
    torch.cuda.synchronize()

    def err(*pairs):
        # dx of a cell whose E is 0 is empty
        return max(float((p.float() - q.float()).abs().max())
                   for p, q in pairs if p.numel())

    # the library's backward: autograd through k2_library's calls
    lw = [t.clone().requires_grad_() for t in (w_cat, b_sum)]
    li = [t.clone().requires_grad_() for t in (x, h, c)]
    lt = None if term is None else term.clone().requires_grad_()
    lh, lc = k2_library(torch, lw[0], lw[1], *li, lt, lanes)()
    # x is no input of a cell whose E is 0
    lib_ins = lw + li[int(e == 0):] + ([] if lt is None else [lt])
    cot = tuple(torch.zeros_like(o) if t is None else t.to(o.dtype)
                for t, o in ((dh, lh), (dc, lc)))
    bnd = k2_bwd_bounds(rows, e, hd, x.element_size(), route,
                        0 if term is None else lanes)
    whole = dict(
        full_backward_ms=time_ms(torch, lambda: run(*a, **kw), flush),
        device_full_backward_ms=time_ms(torch, lambda: run(*a, **kw), flush,
                                        lead=DEVICE_LEAD),
        full_backward_plain_ms=time_ms(
            torch, lambda: fused_lstm.lstm_cell_bwd_full_plain(*a[:7],
                                                               **tkw),
            flush),
        full_backward_bound_ms=bnd["full"][0],
        full_backward_bound_by=bnd["full"][1],
        full_backward_max_abs_err=err(*zip(got, want)),
        lstm_cell_backward_ms=time_ms(torch, lambda: torch.autograd.grad(
            (lh, lc), lib_ins, cot, retain_graph=True), flush),
        device_lstm_cell_backward_ms=time_ms(
            torch, lambda: torch.autograd.grad(
                (lh, lc), lib_ins, cot, retain_graph=True), flush,
            lead=DEVICE_LEAD),
        whole_is="the whole backward (the backward kernel, dx·dh, dW·db); "
                 "lstm_cell_backward: the library's backward through "
                 "autograd (torch.lstm_cell's, or with a gate term "
                 "torch.addmm's and torch._thnn_fused_lstm_cell's; it keeps "
                 "its gates)")
    parts = {
        "fused_lstm_cell_bwd": (
            lambda: fused_lstm._run_bwd_kernel(*a[:7], route, split,
                                               parts=True, **tkw),
            lambda: fused_lstm.lstm_cell_bwd_plain(*a[:7], **tkw), "gate",
            "fused_lstm.cu", err((g.d, d_plain))),
        "lstm_bwd_dxh": (
            lambda: fused_lstm._run_dxh_kernel(w_cat, g, x, h, route),
            lambda: fused_lstm.lstm_bwd_dxh_plain(w_cat, g.d, e), "dxh",
            "lstm_bwd.cu", err((dx, pdx), (dhh, pdh))),
        "lstm_bwd_dw": (
            lambda: fused_lstm._run_dw_kernel(x, h, g, w_cat, b_sum, route),
            lambda: fused_lstm.lstm_bwd_dw_plain(x, h, g.d), "dw",
            "lstm_bwd.cu", err((dw, pdw), (db, pdb)))}
    made = []
    for kname, (fn, plain, bk, src, e_k) in parts.items():
        ms = time_ms(torch, fn, flush)
        dev_ms = time_ms(torch, fn, flush, lead=DEVICE_LEAD)
        plain_ms = time_ms(torch, plain, flush)
        full = name_of(kname) if name_of else "%s_%s_%s_B%dE%dH%d%s/%s" % (
            kname, route, where, rows, e, hd,
            "" if term is None else "_term" + (
                "" if lanes == 1 else "x%d" % lanes), dn)
        stub_entry(kernels, full).update(
            name=full, route="cuda",
            source="simpleimagecaptionzoo_tpu_torch/csrc/" + src,
            replaces="simpleimagecaptionzoo_tpu/ops/pallas_lstm.py:455",
            max_abs_err=e_k, max_err=e_k, ms=ms, kernel_ms=ms,
            device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bnd[bk][0],
            bound_by=bnd[bk][1], library_ms=None, kernel_route=route,
            shape="B=%d E=%d H=%d%s (%s, the path's own inputs)"
            % (rows, e, hd, "" if term is None else " with a gate term",
               phase), **(whole if bk == "gate" else {}))
        kernels[full].setdefault("launches", 0)
        if count:
            credit_launches(kernels, on_path, tag, count, full)
        made.append(full)
        log(phase + " K2 backward %s (%s) B=%d E=%d H=%d %s: %d launches, "
            "max|err| %.3g; %.4f ms (device alone %.4f), plain %.4f, bound "
            "%.4f ms (%s)" % (dn, route, rows, e, hd, kname, count, e_k, ms,
                              dev_ms, plain_ms, bnd[bk][0], bnd[bk][1]))
    log(phase + " K2 backward %s (%s) B=%d E=%d H=%d, whole: held (%s); "
        "%.4f ms (device alone %.4f), plain %.4f, the library's "
        "backward %.4f (device alone %.4f), bound %.4f ms (%s)"
        % (dn, route, rows, e, hd, ferr, whole["full_backward_ms"],
           whole["device_full_backward_ms"], whole["full_backward_plain_ms"],
           whole["lstm_cell_backward_ms"],
           whole["device_lstm_cell_backward_ms"], bnd["full"][0],
           bnd["full"][1]))
    return made


def _tree_bits_equal(torch, a, b):
    """Same structure, dtypes, shapes and bits (dict keys in any order)."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_tree_bits_equal(torch, a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (len(a) == len(b)
                and all(_tree_bits_equal(torch, x, y) for x, y in zip(a, b)))
    if a is None or b is None:
        return a is None and b is None
    if not hasattr(a, "dtype") or not hasattr(b, "dtype"):
        return type(a) is type(b) and a == b         # a count, a step
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = a.view(ints[a.element_size()]), b.view(ints[b.element_size()])
    return bool(torch.equal(a.cpu(), b.cpu()))


def drive_cli(torch, args, dev, flush, kernels, on_path, bare):
    """Phase 18: ``main.main(build_argparser().parse_args([...]))`` of the
    port, in-process, from a temporary directory holding
    :func:`write_cli_dataset`'s data (removed afterwards): (a)
    AoADetection at the width of Configs/Models/AoADetection.json with
    fixed bottom-up features: train 1 epoch at B=128 (4 XE steps, the val
    greedy in 2 batches of 64), train --start_from checkpoint
    --num_epochs 2 --train_dtype bfloat16, scst_train 1 epoch (4 steps),
    eval --eval_split test --eval_beam_size 3 in float32, bfloat16 and int8
    (SICZ_TPU_INT8_KV=auto: K4 runs), sample of one image; (b) NIC from
    pixels (Configs/Models/NIC.json, the full ResNet-101, the packed shard):
    train --cnn_finetune_start 1 --num_epochs 2 at B=128 (2 steps an
    epoch), then eval --eval_beam_size 3 on 64 test images.  Each training
    op's engine ms a step is set beside its own first step replayed bare
    (the batch already on the card) and beside ``bare``, phases 14 and
    15's ms a step at the same shapes."""
    import tempfile
    from simpleimagecaptionzoo_tpu_torch import main as cli
    from simpleimagecaptionzoo_tpu_torch.engine import (holds,
                                                        model_engines,
                                                        steps)
    from simpleimagecaptionzoo_tpu_torch.engine.checkpoint import \
        CheckpointManager
    from simpleimagecaptionzoo_tpu_torch.engine.optim import (tree_leaves,
                                                              tree_map)
    from simpleimagecaptionzoo_tpu_torch.ops import (fused_head, fused_lstm,
                                                     int8_attention, quant)
    t_phase = time.time()
    models = os.path.join(HERE, "Configs", "Models") + os.sep
    all_counters = {
        "K1": (fused_head.COUNT, fused_head.COUNT_WGMMA,
               fused_head.COUNT_TF32X3, fused_head.COUNT_TF32X2),
        "K2": (fused_lstm.COUNT, fused_lstm.COUNT_WGMMA,
               fused_lstm.COUNT_TF32X3),
        "K2bwd": (fused_lstm.COUNT_BWD, fused_lstm.COUNT_BWD_WGMMA,
                  fused_lstm.COUNT_BWD_TF32X3),
        "K2dxh": (fused_lstm.COUNT_DXH, fused_lstm.COUNT_DXH_WGMMA,
                  fused_lstm.COUNT_DXH_TF32X3),
        "K2dw": (fused_lstm.COUNT_DW, fused_lstm.COUNT_DW_WGMMA,
                 fused_lstm.COUNT_DW_TF32X3),
        "K3": (quant.COUNT, quant.COUNT_WGMMA, quant.COUNT_TF32X2),
        "K4": (int8_attention.COUNT, int8_attention.COUNT_TMA)}

    def n(kind):
        return all_counters[kind][0].n

    state = {"op": None, "engine": None}
    ckpt_saves, xe_steps, greedy_batches = [], [], []
    first = {}                 # op -> the first step or decode call
    held = {}                  # op -> kernel calls held in its replay
    orig = (model_engines.get_engine, steps.make_xe_train_step,
            steps.make_scst_train_step, steps.make_greedy_decode,
            steps.make_beam_decode)

    def cpu_tree(tree):
        return tree_map(lambda t: None if t is None
                        else t.detach().to("cpu", copy=True), tree)

    def get_engine(*a, **kw):
        eng = state["engine"] = orig[0](*a, **kw)
        if eng.cfg.uses_cnn:
            ckpt_saves.append(("init", cpu_tree(eng.tree["params"]["cnn"])))
            save = eng.ckpt.save

            def saving(tree, *sa, **skw):
                ckpt_saves.append(("epoch", cpu_tree(tree["params"]["cnn"])))
                return save(tree, *sa, **skw)
            eng.ckpt.save = saving
        return eng

    def step_maker(i):
        """make_xe_train_step (i=1) or make_scst_train_step (i=2): each
        step's K2 launches counted, the op's first call kept for its
        replay after the op."""
        def make(*a, **kw):
            step = orig[i](*a, **kw)
            family = a[0].config.model_type

            def run(*sa, **skw):
                first.setdefault(state["op"], (step, sa, skw))
                kinds = ("K2", "K2bwd", "K2dxh", "K2dw")
                before = [n(k) for k in kinds]
                out = step(*sa, **skw)
                if i == 1:
                    xe_steps.append((state["op"], family) + tuple(
                        n(k) - b for k, b in zip(kinds, before)))
                return out
            return run
        return make

    def decode_maker(i):
        def make(*a, **kw):
            fn = orig[i](*a, **kw)
            family = a[0].config.model_type

            def run(*da, **dkw):
                first.setdefault(state["op"], (fn, da, dkw))
                before = (n("K1"), n("K2"))
                out = fn(*da, **dkw)
                if i == 3 and not isinstance(out, tuple):
                    greedy_batches.append((state["op"], family,
                                           _steps_taken(out),
                                           n("K1") - before[0],
                                           n("K2") - before[1]))
                return out
            return run
        return make

    def replay(op):
        """After an op, with KernelCalls paused (these launches are
        comparisons, not the path's): a training op's first step from its
        own state and batch (already on the card) CLI_BARE_STEPS times,
        timed as the bare step beside the engine's; an eval's first batch,
        and NIC's first XE step, again with every kernel call held against
        its plain version."""
        fn, a, kw = first.pop(op)
        with calls.paused():
            if op in ("train", "train_resume_bf16", "scst_train"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st = a[0]
                for _ in range(CLI_BARE_STEPS):
                    st, _ = fn(st, *a[1:], **kw)
                torch.cuda.synchronize()
                return {"bare_ms_per_step": (time.perf_counter() - t0) * 1e3
                        / CLI_BARE_STEPS}
            if op not in CLI_HELD_OPS:
                return {}
            broken, shapes = [], []
            with holds.held_calls(broken), holds.recording_shapes(shapes):
                fn(*a, **kw)
            torch.cuda.synchronize()
            require(not broken and shapes and (
                op != "nic_train" or any(s[0] == "K2bwd" for s in shapes)),
                "phase 18 %s: %d of %d kernel calls broke their hold "
                "(first: %s)" % (op, len(broken), len(shapes), broken[:1]))
            held[op] = len(shapes)
            return {"calls_held": len(shapes)}

    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    cwd = os.getcwd()
    calls = KernelCalls()
    results, ops = {}, []
    try:
        os.chdir(root)
        t0 = time.time()
        aoa_ids, nic_ids = write_cli_dataset(torch, root, args.seed, dev)
        results["dataset_s"] = time.time() - t0
        (model_engines.get_engine, steps.make_xe_train_step,
         steps.make_scst_train_step, steps.make_greedy_decode,
         steps.make_beam_decode) = (get_engine, step_maker(1),
                                    step_maker(2), decode_maker(3),
                                    decode_maker(4))
        for c in (c for cs in all_counters.values() for c in cs):
            c.n = 0
        aoa = ["--dataset", "Flickr8K", "--model_type", "AoADetection",
               "--model_config_root", models, "--use_bu", "fixed",
               "--train_batch_size", str(CLI_B), "--scst_train_batch_size",
               str(CLI_B), "--eval_batch_size", str(CLI_EVAL_B),
               "--tqdm_visible", "False", "--seed", str(args.seed)]
        nic = ["--dataset", "Flickr30K", "--model_type", "NIC",
               "--model_config_root", models, "--img_size", str(CLI_SIDE),
               "--train_batch_size",
               str(CLI_B), "--eval_batch_size", str(CLI_EVAL_B),
               "--tqdm_visible", "False", "--seed", str(args.seed)]
        plan = [
            ("train", aoa + ["--operation", "train", "--num_epochs", "1"]),
            ("train_resume_bf16", aoa + [
                "--operation", "train", "--num_epochs", "2", "--start_from",
                "checkpoint", "--train_dtype", "bfloat16"]),
            ("scst_train", aoa + ["--operation", "scst_train",
                                  "--scst_num_epochs", "1"]),
            ("eval_float32", aoa + ["--operation", "eval", "--eval_split",
                                    "test", "--eval_beam_size", "3"]),
            ("eval_bfloat16", aoa + ["--operation", "eval", "--eval_split",
                                     "test", "--eval_beam_size", "3",
                                     "--decode_dtype", "bfloat16"]),
            ("eval_int8", aoa + ["--operation", "eval", "--eval_split",
                                 "test", "--eval_beam_size", "3",
                                 "--decode_dtype", "int8"]),
            ("sample", aoa + ["--operation", "sample", "--img_filename",
                              "img_%d.jpg" % aoa_ids["val"][0]]),
            ("nic_train", nic + ["--operation", "train", "--num_epochs", "2",
                                 "--cnn_finetune_start", "1"]),
            ("nic_eval", nic + ["--operation", "eval", "--eval_beam_size",
                                "3"])]
        require(os.environ.get("SICZ_TPU_INT8_KV") == "auto",
                "phase 18 needs SICZ_TPU_INT8_KV=auto (set in phase 8)")
        sample_log = None
        with calls.recording(torch):
            for op, argv in plan:
                state["op"] = op
                t0 = time.time()
                if op == "sample":
                    buf = __import__("io").StringIO()
                    with contextlib.redirect_stdout(buf):
                        rc = cli.main(cli.build_argparser().parse_args(argv))
                    sample_log = buf.getvalue()
                    sys.stdout.write(sample_log)
                else:
                    rc = cli.main(cli.build_argparser().parse_args(argv))
                torch.cuda.synchronize()
                ops.append(dict(op=op, rc=rc, seconds=time.time() - t0))
                require(rc == 0, "phase 18 %s: main returned %s" % (op, rc))
                eng, rec = state["engine"], ops[-1]
                for attr in ("last_epoch", "last_eval", "last_save_s",
                             "last_load_s", "last_coco_eval_s"):
                    if hasattr(eng, attr):
                        rec[attr] = getattr(eng, attr)
                if op in ("train", "train_resume_bf16", "nic_train"):
                    # the file on disk, read back on the CPU, is the
                    # engine's tree bit for bit; masters stay float32
                    host = cpu_tree(eng.tree)
                    back, his, _ = CheckpointManager(
                        eng.cfg.model_type, eng.data_cfg.dataset_name).load(
                        host)
                    require(back is not None
                            and _tree_bits_equal(torch, back, host),
                            "phase 18 %s: the checkpoint read back differs "
                            "from the engine's tree" % op)
                    require(all(t.dtype == torch.float32 for t in
                                tree_leaves(back["params"])),
                            "phase 18 %s: the saved params are not all "
                            "float32" % op)
                    rec["cider_his"] = his
                    rec["losses"] = list(eng.epoch_losses)
                rec.update(replay(op))
        results["ops"] = ops

        # -- gates
        mdir = os.path.join("CheckPoints",
                            "Model_AoADetection_Dataset_Flickr8K")
        for path in ("cp/Captioner_cp.msgpack", "cp/state_histories.json",
                     "cp/Captioner_scst_cp.msgpack",
                     "cp/scst_state_histories.json", "metrics.jsonl"):
            require(os.path.exists(os.path.join(mdir, path)),
                    "phase 18: %s missing" % path)
        require(os.path.exists("coco_caption/results/captions-generate.json")
                and os.path.exists("Data/cider_idf_table.npz"),
                "phase 18: the results json or the idf npz is missing")
        his = [o.get("cider_his") for o in ops
               if o["op"] in ("train", "train_resume_bf16")]
        require([len(h) for h in his] == [1, 2], "phase 18: state_histories "
                "after the two XE runs: %s" % his)
        with open(os.path.join(mdir, "metrics.jsonl")) as f:
            recs = [json.loads(x) for x in f]
        phases = [(r["phase"], r.get("epoch")) for r in recs]
        require(phases == [("xe", 1), ("xe", 2), ("scst", 1), ("eval", None),
                           ("eval", None), ("eval", None)],
                "phase 18: metrics.jsonl records %s" % phases)
        losses = ops[0]["losses"]
        require(len(losses) == 4 and all(map(math.isfinite, losses))
                and losses[-1] < losses[0],
                "phase 18: the first epoch's XE losses %s (finite, falling)"
                % losses)
        # routes: every launch on its tensor-core route (K4 on "tma")
        for kind, cs in all_counters.items():
            require(cs[0].n == sum(c.n for c in cs[1:]) and cs[0].n > 0,
                    "phase 18 %s: %d launches, %s on the tensor-core routes"
                    % (kind, cs[0].n, [c.n for c in cs[1:]]))
        aoa_xe = [s for s in xe_steps if s[1] == "AoADetection"]
        require(len(aoa_xe) == 8
                and all(s[2:] == (21, 21, 21, 21) for s in aoa_xe),
                "phase 18: AoADetection XE steps' K2 forward, backward "
                "kernel, dx·dh and dW·db launches %s (21 each)" % aoa_xe)
        for op, fam, steps_taken, k1, k2 in greedy_batches:
            want_k2 = steps_taken + (fam == "NIC")
            require(k1 == steps_taken and k2 == want_k2,
                    "phase 18 %s %s greedy batch: K1 %d and K2 %d launches "
                    "for %d steps" % (op, fam, k1, k2, steps_taken))
        require(len([g for g in greedy_batches if g[1] == "AoADetection"])
                == 2 * 2 + 2, "phase 18: AoADetection greedy val batches %s"
                % greedy_batches)
        require(set(held) == set(CLI_HELD_OPS), "phase 18: held %s" % held)
        # without matplotlib (the card's machine has none) the hook says
        # so in one line and draws nothing
        import importlib.util
        no_mpl = importlib.util.find_spec("matplotlib") is None
        require(sample_log and "Generated caption:" in sample_log
                and "ground-truth captions:" in sample_log
                and (model_engines.NO_MATPLOTLIB in sample_log) == no_mpl,
                "phase 18 sample: the log lacks the caption, or the "
                "matplotlib line %s" % ("is missing" if no_mpl
                                        else "appears with matplotlib"))
        # NIC: epoch 1 leaves the ResNet as it was, epoch 2 fine-tunes
        # layer4 alone
        init = [t for k, t in ckpt_saves if k == "init"]
        saved = [t for k, t in ckpt_saves if k == "epoch"]
        require(len(init) >= 1 and len(saved) == 2,
                "phase 18 NIC: %d inits and %d saves" % (len(init),
                                                         len(saved)))
        cnn0 = init[0]
        require(_tree_bits_equal(torch, saved[0], cnn0),
                "phase 18 NIC: epoch 1 moved the frozen ResNet")
        for stage in cnn0:
            same = _tree_bits_equal(torch, saved[1][stage], cnn0[stage])
            require(same != (stage == "layer4"),
                    "phase 18 NIC: after epoch 2 %s %s" % (
                        stage, "is unchanged" if same else "changed"))
        results["nic_xe_k2"] = [s[2:] for s in xe_steps if s[1] == "NIC"]
        results["greedy_batches"] = greedy_batches
        results["held_calls"] = held
        results["aoa_xe_steps"] = len(aoa_xe)
        results["kernel_entries"] = cli_kernel_entries(
            torch, calls, kernels, on_path, flush, "phase 18 CLI")
    finally:
        (model_engines.get_engine, steps.make_xe_train_step,
         steps.make_scst_train_step, steps.make_greedy_decode,
         steps.make_beam_decode) = orig
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)

    # -- measurements
    by_op = {o["op"]: o for o in ops}
    xe_f32 = by_op["train"]["last_epoch"]
    xe_bf16 = by_op["train_resume_bf16"]["last_epoch"]
    scst = by_op["scst_train"]["last_epoch"]
    meas = dict(
        xe_steps_per_s=xe_f32["steps_per_sec"],
        xe_bf16_steps_per_s=xe_bf16["steps_per_sec"],
        scst_steps_per_s=scst["steps_per_sec"])
    for what, op, key in (("xe", "train", "xe/float32"),
                          ("xe_bf16", "train_resume_bf16", "xe/bfloat16"),
                          ("scst", "scst_train", "scst/float32")):
        ms = 1e3 / by_op[op]["last_epoch"]["steps_per_sec"]
        here = by_op[op]["bare_ms_per_step"]
        meas[what + "_ms_per_step"] = ms
        meas[what + "_bare_ms_per_step"] = here
        meas[what + "_overhead_ms"] = ms - here
        meas[what + "_phase14_15_bare_ms_per_step"] = bare[key]
        meas[what + "_overhead_over_phase14_15_ms"] = ms - bare[key]
    for op in ("eval_float32", "eval_bfloat16", "eval_int8", "nic_eval"):
        ev = by_op[op]["last_eval"]
        meas[op + "_captions_per_s"] = ev["captions"] / ev["seconds"]
    meas["coco_eval_s"] = {o["op"]: o["last_coco_eval_s"] for o in ops
                           if "last_coco_eval_s" in o}
    meas["checkpoint_save_ms"] = {o["op"]: 1e3 * o["last_save_s"]
                                  for o in ops if "last_save_s" in o}
    meas["checkpoint_load_ms"] = {o["op"]: 1e3 * o["last_load_s"]
                                  for o in ops if "last_load_s" in o}
    results["measured"] = meas
    results["seconds"] = time.time() - t_phase
    log("phase 18: %s" % json.dumps(meas))
    log("phase 18: ops %s" % ", ".join("%s %.1f s" % (o["op"], o["seconds"])
                                       for o in ops))
    log("phase 18 took %.1f s (dataset %.1f s)" % (results["seconds"],
                                                   results["dataset_s"]))
    require(results["seconds"] <= CLI_PHASE_S, "phase 18 took %.1f s, over "
            "its %.0f s" % (results["seconds"], CLI_PHASE_S))
    return results


# -- phase 19: serving on the card -----------------------------------------
SERVE_IMAGES = 512            # photo-like JPEGs, 160-640 px a side
SERVE_SIDES = (160, 640)
SERVE_FAMILY, SERVE_DATASET = "BUTDSpatial", "Serve"   # the tools' default
# (--max_batch, --dtype, --beam) of each server: beam 3 bf16 at three
# batch sizes, and at 64 int8 and greedy float32
SERVE_RUNS = ((16, "bfloat16", 3), (64, "bfloat16", 3), (192, "bfloat16", 3),
              (64, "int8", 3), (64, "float32", -1))
SERVE_DIR_BATCH = 64          # the directory run's --batch
PHASES_19_20_S = 120.0        # phases 19 and 20 together
# phase 20's timed steps per variant (with 4, phases 19-20 read up to 122
# s on the H100, and with 3 up to 127.5 s on a slow host, over their 120 s)
PX_STEPS = 2
# phase 20 profiles the float32 variant of each run (a profiled step from
# pixels takes seconds: the trunk's thousands of launches traced)
PX_PROFILED = ("float32",)


def write_serve_layout(torch, root, seed, dev, gen, seconds=None):
    """Phase 19's layout under ``root``: Phase 18's vocabulary
    (:func:`write_vocab`), Configs/Datasets/Serve.data, a best checkpoint
    of BUTDSpatial at the width of Configs/Models/BUTDSpatial.json with the
    full ResNet-101 (random from ``gen``, running statistics calibrated as
    phase 17's), saved by the port's CheckpointManager, and photos/: 512
    photo-like JPEGs (PIL, quality 90) whose sides are drawn from 160-640
    px, and one corrupt file.  -> (the tools' flags, the photos' directory,
    the JPEGs' bytes in name order); ``seconds`` (a dict), when given,
    gets the checkpoint's and the photos' seconds."""
    import io
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor
    from PIL import Image
    from simpleimagecaptionzoo_tpu_torch.config import load_model_config
    from simpleimagecaptionzoo_tpu_torch.engine.checkpoint import \
        CheckpointManager
    from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
    t0 = time.time()
    write_vocab(root)
    with open(os.path.join(root, "Configs", "Datasets",
                           SERVE_DATASET + ".data"), "w") as f:
        f.write("image_root=/photos/\ndata_dir=/Data/\n"
                "caption_vocab_path=/Data/caption_vocab.pkl\n")
    models = os.path.join(HERE, "Configs", "Models") + os.sep
    model = get_captioner(load_model_config(
        models + SERVE_FAMILY + ".json", vocab_size=CLI_VOCAB))
    params = model.init_params(gen, include_cnn=True)
    cal = calibrated_stats(torch, params["cnn"],
                           model.init_model_state()["cnn_stats"],
                           photo_batch(torch, gen, CAL_B, 224, dev))
    ck_root = os.path.join(root, "CheckPoints")
    CheckpointManager(SERVE_FAMILY, SERVE_DATASET, root=ck_root).save_best(
        {"params": params, "model_state": {"cnn_stats": cal}}, 0.0)
    del params, cal
    t1 = time.time()
    rng = np.random.default_rng(seed + 19)
    hw = rng.integers(SERVE_SIDES[0], SERVE_SIDES[1] + 1,
                      size=(SERVE_IMAGES, 2))
    photos = os.path.join(root, "photos")
    os.makedirs(photos)
    jpegs = []
    for i in range(0, SERVE_IMAGES, 128):
        big = photo_batch(torch, gen, 128, SERVE_SIDES[1], dev).cpu().numpy()

        def encode(j, big=big, i=i):
            h, w = hw[i + j]
            buf = io.BytesIO()
            Image.fromarray(big[j, :h, :w]).save(buf, format="JPEG",
                                                 quality=90)
            return buf.getvalue()
        with ThreadPoolExecutor(max_workers=8) as pool:
            jpegs += list(pool.map(encode, range(len(big))))
    for i, data in enumerate(jpegs):
        with open(os.path.join(photos, "img_%03d.jpg" % i), "wb") as f:
            f.write(data)
    with open(os.path.join(photos, "corrupt.jpg"), "wb") as f:
        f.write(b"\xff\xd8\xff\xe0 not a jpeg")
    if seconds is not None:
        seconds.update(layout_checkpoint=t1 - t0,
                       layout_photos=time.time() - t1)
    flags = ["--dataset", SERVE_DATASET, "--model_type", SERVE_FAMILY,
             "--dataset_config_root",
             os.path.join(root, "Configs", "Datasets") + os.sep,
             "--model_config_root", models, "--checkpoint_root", ck_root,
             "--gpu_id", "0"]
    return flags, photos, jpegs


def _post(url, data, timeout=300):
    """POST ``data`` to ``url`` -> (status, reply json, seconds)."""
    import urllib.error
    import urllib.request
    t0 = time.perf_counter()
    req = urllib.request.Request(url, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            code, body = r.status, json.load(r)
    except urllib.error.HTTPError as e:
        code, body = e.code, json.load(e)
    return code, body, time.perf_counter() - t0


def _get(url):
    import urllib.request
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.load(r)


def _load(url, n, paths):
    """scripts/serve_load.py in a process of its own: ``n`` client threads
    POST the files ``paths`` to ``url``, started together -> (the replies
    as :func:`_post`'s, in order; the seconds from the first send to the
    last reply, the load generator's clock)."""
    res = subprocess.run(
        [sys.executable, os.path.join(HERE, "scripts", "serve_load.py"), url,
         str(n)], input="\n".join(paths), capture_output=True, text=True,
        timeout=600)
    require(res.returncode == 0, "the load generator exited %d: %s"
            % (res.returncode, res.stderr[-500:]))
    out = json.loads(res.stdout.strip().splitlines()[-1])
    return [tuple(r) for r in out["replies"]], out["seconds"]


def _percentile(xs, q):
    import numpy as np
    return float(np.percentile(np.asarray(xs, np.float64), q))


def drive_serve(torch, args, dev, gen, smi, flush, kernels, on_path):
    """Phase 19: the port's serving surface on the card, from pixels.  In a
    temporary directory (removed afterwards) :func:`write_serve_layout`
    writes a BUTDSpatial checkpoint and 512 JPEGs and a corrupt file.

    (a) ``tools.caption_images.main`` over the directory, beam 3, bf16 and
    int8, ``--batch 64``: the corrupt file reported and left out.  (b)
    ``tools.caption_server``, built through ``build_argparser().parse_args``
    and ``build_server`` on port 0, for each of SERVE_RUNS; per server a
    load generator in a process of its own (scripts/serve_load.py) with N
    client threads POSTs JPEG files to ``/caption`` on 127.0.0.1 at N = 1,
    max_batch and 4 x max_batch (each request its own image, in turn),
    and this process the corrupt bytes once.  Gates: every reply 200
    with a string caption, the corrupt upload 400; ``/stats`` rows_decoded
    = batches x max_batch; every
    launch on its dtype's tensor-core route, exactly one K1 (m = k x
    max_batch) and both BUTD cells (or int8: K3 three times) a step, read
    from the counters after the server stopped; the ids hold: every
    caption the server and the directory run gave equals the caption of
    that image decoded in-process by the same bundle in full batches of
    max_batch (other batch-mates, other positions); one padded batch of
    each bundle decoded with every kernel call held and the winners gated
    against the plain versions (beam_gate; greedy float32: rows
    identical), the plain run on the same feature map (TrunkMemo).  Every
    launch shape gets an entry ``<kernel>_<route>_serve_<shape>``."""
    import io
    import tempfile
    import threading
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor
    from simpleimagecaptionzoo_tpu_torch import inference
    from simpleimagecaptionzoo_tpu_torch.data import _native_image
    from simpleimagecaptionzoo_tpu_torch.engine import holds
    from simpleimagecaptionzoo_tpu_torch.models import resnet
    from simpleimagecaptionzoo_tpu_torch.ops import (fused_head, fused_lstm,
                                                     int8_attention, quant)
    from simpleimagecaptionzoo_tpu_torch.tools import caption_images as CI
    from simpleimagecaptionzoo_tpu_torch.tools import caption_server as CS
    t19 = time.time()
    out = {"card": smi, "seconds": {}}
    root = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    cwd = os.getcwd()
    counters = {"K1": (fused_head.COUNT, fused_head.COUNT_WGMMA,
                       fused_head.COUNT_TF32X3),
                "K2": (fused_lstm.COUNT, fused_lstm.COUNT_WGMMA,
                       fused_lstm.COUNT_TF32X3),
                "K3": (quant.COUNT, quant.COUNT_WGMMA),
                "K4": (int8_attention.COUNT,)}
    calls = KernelCalls()
    bundles = []
    load = inference.load_inference_bundle

    def keeping(**kw):
        bundles.append(load(**kw))
        return bundles[-1]

    try:
        os.chdir(root)
        flags, photos, jpegs = write_serve_layout(torch, root, args.seed,
                                                  dev, gen, out["seconds"])
        out["seconds"]["layout"] = time.time() - t19
        # the host's upload decode, one thread: native (when built) and PIL
        sample = jpegs[:64]
        t0 = time.perf_counter()
        for b in sample:
            CS.decode_upload(b, 224)
        up_ms = (time.perf_counter() - t0) * 1e3 / len(sample)
        from PIL import Image
        t0 = time.perf_counter()
        for b in sample:
            with Image.open(io.BytesIO(b)) as im:
                np.asarray(im.convert("RGB").resize((224, 224),
                                                    Image.BILINEAR))
        pil_ms = (time.perf_counter() - t0) * 1e3 / len(sample)
        out["upload_decode"] = dict(
            native_built=_native_image.available(), decode_upload_ms=up_ms,
            pil_ms=pil_ms)
        log("phase 19 upload decode on the host (%s): decode_upload %.3f "
            "ms an image (%s ran), PIL %.3f ms" % (
                smi, up_ms, "native" if _native_image.available() else "PIL",
                pil_ms))
        with ThreadPoolExecutor(max_workers=8) as pool:
            pix = np.stack(list(pool.map(lambda b: CS.decode_upload(b, 224),
                                         jpegs)))
        inference.load_inference_bundle = keeping
        runs, dir_caps = {}, {}
        out["seconds"]["upload_decode"] = time.time() - t19 - \
            out["seconds"]["layout"]
        t_dir = time.time()
        with calls.recording(torch):
            # (a) the directory run, bf16 and int8
            for dt in ("bfloat16", "int8"):
                cap_out = os.path.join(root, "caps_%s.json" % dt)
                so, se = io.StringIO(), io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(so), \
                        contextlib.redirect_stderr(se):
                    rc = CI.main(["--image_dir", photos] + flags + [
                        "--beam", "3", "--batch", str(SERVE_DIR_BATCH),
                        "--dtype", dt, "--out", cap_out])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                with open(cap_out) as f:
                    res = json.load(f)
                rate = re.search(r"\(([0-9.]+) images/sec\)", so.getvalue())
                require(rc == 0 and len(res) == SERVE_IMAGES
                        and "corrupt.jpg" not in {r["file_name"] for r in res}
                        and "skipping unreadable image 'corrupt.jpg'"
                        in se.getvalue() and rate is not None,
                        "phase 19 caption_images %s: rc %s, %d results, the "
                        "corrupt file not reported and skipped: %s"
                        % (dt, rc, len(res), se.getvalue()[-300:]))
                dir_caps[dt] = {int(r["file_name"][4:7]): r["caption"]
                                for r in res}
                runs["dir/" + dt] = dict(images_per_s=float(rate.group(1)),
                                         wall_s=wall, bundle=bundles[-1])
                log("phase 19 caption_images beam 3 %s --batch %d (%s): %d "
                    "images, corrupt.jpg skipped; %.1f images/s (the tool's "
                    "own clock), %.2f s with the bundle's load"
                    % (dt, SERVE_DIR_BATCH, smi, len(res),
                       float(rate.group(1)), wall))
            out["seconds"]["directory_runs"] = time.time() - t_dir
            # (b) the servers
            nxt = 0
            for mb, dt, beam in SERVE_RUNS:
                t_srv = time.time()
                key = "%s/beam%d/mb%d" % (dt, beam, mb)
                for cs in counters.values():
                    for c in cs:
                        c.n = 0
                shapes0 = len(calls.shapes)
                sargs = CS.build_argparser().parse_args(flags + [
                    "--beam", str(beam), "--max_batch", str(mb), "--dtype",
                    dt, "--port", "0", "--max_wait_ms", "20"])
                enc0 = fused_lstm.map_encodes()
                t0 = time.perf_counter()
                httpd, batcher = CS.build_server(sargs)
                build_s = time.perf_counter() - t0
                enc_warm = fused_lstm.map_encodes()
                thread = threading.Thread(target=httpd.serve_forever,
                                          daemon=True)
                thread.start()
                url = "http://127.0.0.1:%d" % httpd.server_address[1]
                code, body, _ = _post(url + "/caption", b"\xff\xd8\xff\xe0 "
                                      b"not a jpeg")
                require(code == 400, "phase 19 %s: the corrupt upload gave "
                        "%d %s" % (key, code, body))
                served, loads = {}, []
                try:
                    for n in (1, mb, 4 * mb):
                        idx = [(nxt + i) % SERVE_IMAGES for i in range(n)]
                        nxt += n
                        before = _get(url + "/stats")
                        got, wall = _load(url + "/caption", n, [
                            os.path.join(photos, "img_%03d.jpg" % i)
                            for i in idx])
                        st = _get(url + "/stats")
                        bad = [(c, b) for c, b, _ in got if c != 200
                               or not isinstance(b.get("caption"), str)]
                        require(not bad, "phase 19 %s N=%d: %d replies not "
                                "200 with a caption (first: %s)"
                                % (key, n, len(bad), bad[:1]))
                        for i, (_, b, _) in zip(idx, got):
                            served.setdefault(i, set()).add(b["caption"])
                        lat = [t * 1e3 for _, _, t in got]
                        nb = st["batches"] - before["batches"]
                        loads.append(dict(
                            n=n, seconds=wall, captions_per_s=n / wall,
                            batches=nb,
                            mean_batch_fill=(st["requests"]
                                             - before["requests"]) / nb,
                            client_p50_ms=_percentile(lat, 50),
                            client_p99_ms=_percentile(lat, 99),
                            stats_p50_ms=st.get("latency_ms_p50"),
                            stats_p99_ms=st.get("latency_ms_p99")))
                        log("phase 19 server %s N=%d (%s): %.1f captions/s, "
                            "%d batches, mean fill %.2f of %d; latency p50 "
                            "%.1f ms, p99 %.1f ms (clients); /stats since "
                            "the start: p50 %s ms, p99 %s ms"
                            % (key, n, smi, n / wall, nb,
                               loads[-1]["mean_batch_fill"], mb,
                               loads[-1]["client_p50_ms"],
                               loads[-1]["client_p99_ms"],
                               st.get("latency_ms_p50"),
                               st.get("latency_ms_p99")))
                    stats = _get(url + "/stats")
                finally:
                    httpd.shutdown()
                    httpd.server_close()
                    batcher.stop()
                    thread.join(timeout=30)
                torch.cuda.synchronize()
                encodes = fused_lstm.map_encodes() - enc_warm
                require(stats["rows_decoded"] == stats["batches"] * mb,
                        "phase 19 %s: /stats %s (rows_decoded != batches x "
                        "%d)" % (key, stats, mb))
                # launches, read after the server stopped
                route = "tf32x3" if dt == "float32" else "wgmma"
                k = max(beam, 1)
                got = {}
                for s in calls.shapes[shapes0:]:
                    got[s] = got.get(s, 0) + 1
                n_steps = got.get(("K1", route, k * mb, k), 0)
                rows = k * mb
                if dt == "int8":
                    want = {("K3", route, rows, w): n_steps
                            for w in (5120, 4096, 1024)}
                    kinds = ("K1", "K3")
                else:
                    # the attention cell hoisted ([h2, emb], 2,048), the
                    # language cell [attended, h1] (3,072)
                    want = {("K2", route, rows, w): n_steps
                            for w in (2048, 3072)}
                    kinds = ("K1", "K2")
                want[("K1", route, rows, k)] = n_steps
                cap = inference.BEAM_MAX_LEN if beam > 0 else \
                    inference.GREEDY_MAX_LEN
                n_dec = stats["batches"] + 1            # and the warm-up
                require(got == want and n_dec <= n_steps <= cap * n_dec,
                        "phase 19 %s: launches by shape %s, expected %s "
                        "(%d decodes)" % (key, got, want, n_dec))
                tc = 1 if route == "wgmma" else 2
                for kind, cs in counters.items():
                    on = kind in kinds
                    require(cs[0].n == (n_steps * (3 if kind == "K3" else
                                                   2 if kind == "K2" else 1)
                                        if on else 0)
                            and (not on or cs[min(tc, len(cs) - 1)].n
                                 == cs[0].n),
                            "phase 19 %s: %s launched %s (route counters)"
                            % (key, kind, [c.n for c in cs]))
                runs[key] = dict(
                    max_batch=mb, dtype=dt, beam=beam, build_s=build_s,
                    warm_s=batcher.warm_s, map_encodes_warm=enc_warm - enc0,
                    map_encodes_after_warm=encodes,
                    loads=loads, stats=stats, steps=n_steps,
                    decodes=n_dec, served=served, bundle=bundles[-1])
                out["seconds"]["server " + key] = time.time() - t_srv
                log("phase 19 server %s: built and warmed in %.2f s (warm "
                    "%.2f s on the batcher's thread); K2's TMA maps encoded "
                    "by the warm decode %d, by the %d served batches after "
                    "it %d (activations the allocator moved: a map is "
                    "cached by its buffer); %d decodes, %d steps, per step "
                    "%s on %s, exactly; /stats %s"
                    % (key, build_s, batcher.warm_s, enc_warm - enc0,
                       stats["batches"], encodes, n_dec,
                       n_steps, ", ".join(sorted(
                           "%s m=%d %s" % (s[0], s[2], s[3]) for s in want)),
                       route, stats))
        inference.load_inference_bundle = load
        out["seconds"]["served"] = time.time() - t19

        # the ids hold and the bundle's holds, after the servers stopped
        def decode_all(b, idx, mb):
            """{image: caption} of ``idx`` decoded by bundle ``b`` in full
            batches of ``mb`` (the last padded), and each batch's
            seconds."""
            caps, secs = {}, []
            for s in range(0, len(idx), mb):
                chunk = idx[s:s + mb]
                rows = chunk + [chunk[-1]] * (mb - len(chunk))
                x = torch.from_numpy(pix[rows]).to(dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ids = b.decode(b.tree["params"], b.tree["model_state"],
                               {"img_tensors": x}).cpu().numpy()
                secs.append(time.perf_counter() - t0)
                for i, row in zip(chunk, ids):
                    caps[i] = " ".join(b.vocab.decode_ids(row))
            return caps, secs

        out["runs"] = {}
        for key, r in runs.items():
            t_k = [time.time()]
            b = r.pop("bundle")
            if key.startswith("dir/"):
                out["runs"][key] = r
                continue
            mb = r["max_batch"]
            idx = sorted(r["served"])
            if mb == SERVE_DIR_BATCH and r["dtype"] in dir_caps:
                idx = list(range(SERVE_IMAGES))
            ref, secs = decode_all(b, idx, mb)
            t_k.append(time.time())
            served = r.pop("served")
            differ = [i for i, cs in served.items() if cs != {ref[i]}]
            require(not differ, "phase 19 %s: %d images' served captions "
                    "differ from the in-process decode in full batches of "
                    "%d (first: image %s, %s against %s)"
                    % (key, len(differ), mb, differ[:1],
                       [served[i] for i in differ[:1]],
                       [ref[i] for i in differ[:1]]))
            if mb == SERVE_DIR_BATCH and r["dtype"] in dir_caps:
                dd = [i for i, c in dir_caps[r["dtype"]].items()
                      if c != ref[i]]
                require(not dd, "phase 19 caption_images %s: %d captions "
                        "differ from the in-process decode (first: %s)"
                        % (r["dtype"], len(dd), dd[:3]))
                r["directory_ids_hold"] = len(dir_caps[r["dtype"]])
            r["ids_held"] = len(idx)
            t_med = sorted(secs)[len(secs) // 2]
            r["offline_captions_per_s"] = mb / t_med
            r["offline_batch_s"] = secs
            # one padded batch: every kernel call held, the winners gated
            # against the plain versions on the same feature map
            chunk = idx[:mb]
            rows = chunk + [chunk[-1]] * (mb - len(chunk))
            vis = {"img_tensors": torch.from_numpy(pix[rows]).to(dev)}
            prm, ms = b.tree["params"], b.tree["model_state"]
            memo = TrunkMemo(resnet)
            try:
                ids = b.decode(prm, ms, vis)
                memo.mode = "pass"
                broken = []
                with holds.held_calls(broken):
                    b.decode(prm, ms, vis)
                torch.cuda.synchronize()
                require(not broken, "phase 19 %s: %d kernel calls of the "
                        "bundle's decode broke their hold (first: %s)"
                        % (key, len(broken), broken[:1]))
                with memo.replaying(), holds.plain_versions():
                    ref_ids = b.decode(prm, ms, vis)
                dtype = (torch.float32 if r["dtype"] == "float32"
                         else torch.bfloat16)
                if r["beam"] > 0:
                    with memo.replaying():
                        margin = holds.rescored_margin(
                            b.model, prm, vis, ids, ref_ids, dtype, dev, ms)
                    tol = holds.beam_tol(dtype, inference.BEAM_MAX_LEN)
                    passed, same = holds.beam_gate(False, ids, ref_ids,
                                                   margin, tol)
                    r["gate"] = dict(rows_identical=same,
                                     min_margin=float(margin.min()), tol=tol)
                else:
                    passed, same = holds.beam_gate(True, ids, ref_ids, None,
                                                   0.0)
                    r["gate"] = dict(rows_identical=same)
                require(passed, "phase 19 %s: the bundle's batch against "
                        "the plain versions: %s" % (key, r["gate"]))
            finally:
                memo.close()
            t_k.append(time.time())
            prof = profile_decode(torch, lambda: b.decode(prm, ms, vis),
                                  "phase 19 " + key)
            t_k.append(time.time())
            # the in-process decode, the held and gated batch, the profile
            out["seconds"]["holds " + key] = [
                y - x for x, y in zip(t_k, t_k[1:])]
            r["idle_share_of_span"] = 1 - (prof["device_busy_ms"]
                                           / prof["device_span_ms"])
            r["idle_share_of_wall"] = 1 - prof["device_busy_ms"] / (
                t_med * 1e3)
            out["runs"][key] = r
            sat = r["loads"][-1]["captions_per_s"]
            log("phase 19 %s (%s): every served caption of %d images equals "
                "the in-process decode in full batches of %d; a padded "
                "batch held (every kernel call) and gated %s; offline %.1f "
                "captions/s (cap %d, no HTTP) against %.1f served at "
                "N=%d; one profiled batch idle %.1f %% of its span, %.1f %% "
                "of the unprofiled wall"
                % (key, smi, len(idx), mb, r["gate"], mb / t_med,
                   inference.BEAM_MAX_LEN if r["beam"] > 0
                   else inference.GREEDY_MAX_LEN, sat,
                   r["loads"][-1]["n"], 100 * r["idle_share_of_span"],
                   100 * r["idle_share_of_wall"]))
        del pix
        t_e = time.time()
        out["kernel_entries"] = cli_kernel_entries(
            torch, calls, kernels, on_path, flush, "phase 19 serving",
            where="serve", phase="phase 19")
        out["seconds"]["entries"] = time.time() - t_e
    finally:
        inference.load_inference_bundle = load
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"]["total"] = time.time() - t19
    log("phase 19 took %.1f s (%s)" % (out["seconds"]["total"], {
        k: (round(v, 2) if isinstance(v, float) else [round(x, 2) for x in v])
        for k, v in out["seconds"].items()}))
    return out


def drive_pixel_training(torch, args, dev, gen, smi, flush, kernels,
                         on_path, scst):
    """Phase 20: training from pixels on the card.  BUTDSpatial and
    AoASpatial at their published widths (vocab 10,102), XE with ``layer4``
    fine-tuned (Adam at the json's lr and cnn_FT_lr, scheduled sampling at
    0.25) and SCST (scst_lr, scst_cnn_FT_lr), each in float32 and in bf16
    over float32 masters; NIC's SCST likewise.  One full ResNet-101 (random
    from ``gen``, its statistics calibrated as phase 17's) serves the three;
    B=128 photo-like uint8 images at 224 staged on the card, the captions
    of phase 14 and the references and table of phase 15.  Each run is
    :func:`drive_xe` or :func:`drive_scst` from pixels: the first step
    against the plain versions with the fine-tune scope exact, PX_STEPS
    timed steps with K2's forward and whole backward launches per step
    exact, one step with every kernel call held, one profiled step (the
    trunk's forward and cuDNN's backward through layer4 among its parts).
    K1 at the 512-wide heads' training rows (m=128) gets entries of its own
    (``..._px_train_...``)."""
    from simpleimagecaptionzoo_tpu_torch.config import load_model_config
    from simpleimagecaptionzoo_tpu_torch.models import resnet
    from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
    t20 = time.time()
    out = {"card": smi}
    cnn, stats0 = resnet.init(gen)
    cal = calibrated_stats(torch, cnn, stats0,
                           photo_batch(torch, gen, CAL_B, 224, dev))
    visual = {"img_tensors": photo_batch(torch, gen, TRAIN_B, 224, dev)}
    calls = KernelCalls()
    bf = torch.bfloat16
    models = os.path.join(HERE, "Configs", "Models")
    failed = []
    for fam in ("BUTDSpatial", "AoASpatial", "NIC"):
        model = get_captioner(load_model_config(
            os.path.join(models, fam + ".json"), vocab_size=CLI_VOCAB))
        cfg = model.config
        params = dict(model.init_params(gen), cnn=cnn)
        if fam == "BUTDSpatial":
            # the attention cell hoisted: x = [h2, emb], td_mean_gates its
            # gate term (phase 22's entries ..._butd_td_hoist)
            cells = [("_butd_td_hoist", cfg.hidden_dim + cfg.embed_dim),
                     ("_butd_lang", cfg.enc_dim + cfg.hidden_dim)]
        elif fam == "AoASpatial":
            cells = [("_aoasp", cfg.embed_dim + cfg.hidden_dim)]
        else:
            cells = [("_nic", cfg.embed_dim)]
        ms = {"cnn_stats": cal}
        name = fam + " from pixels"
        r = out[fam] = {}
        torch.cuda.reset_peak_memory_stats()
        runs = []
        if fam != "NIC":
            runs.append(("xe", lambda: drive_xe(
                torch, args, dev, model, params, kernels, on_path, name=name,
                cells=cells, lr=cfg.lr, n_timed=PX_STEPS,
                variants=[("float32", None, True), ("bfloat16", bf, True)],
                visual=visual, model_state=ms, lr_cnn=cfg.cnn_ft_lr,
                profiled=PX_PROFILED)))
        runs.append(("scst", lambda: drive_scst(
            torch, args, dev, model, params, kernels, on_path, scst,
            name=name, cells=cells, lr=cfg.scst_lr, n_timed=PX_STEPS,
            variants=[("float32", None), ("bfloat16", bf)], visual=visual,
            model_state=ms, lr_cnn=cfg.scst_cnn_ft_lr,
            calls=None if fam == "BUTDSpatial" else calls,
            init_cell=fam == "NIC", profiled=PX_PROFILED,
            relu_replay=fam == "BUTDSpatial")))
        for kind, run in runs:
            # a run that fails its gates fails the phase after the others
            # ran, so that one failure does not hide the rest
            t_run = time.time()
            try:
                r[kind] = run()
                out.setdefault("split_s", {})["%s %s" % (fam, kind)] = \
                    run_split(r[kind], time.time() - t_run)
            except RuntimeError as e:
                failed.append("%s %s: %s" % (fam, kind, e))
                log("phase 20 %s %s FAILED, the phase fails after the "
                    "other runs: %s" % (fam, kind, e))
        for kind in ("xe", "scst"):
            for label, res in r.get(kind, {}).items():
                p = res.get("profile")
                log("phase 20 %s %s %s (%s): %.2f ms a step, %.1f "
                    "samples/s, peak memory %.2f GiB%s" % (
                        fam, kind, label, smi, res["ms_per_step"],
                        res["samples_per_s"], res["peak_memory_gib"],
                        "" if p is None else
                        "; profiled: idle %.1f %% of the span, the trunk's "
                        "forward %.3f ms, cuDNN's backward through layer4 "
                        "%.3f ms, K2 backward's float32 products %.3f ms"
                        % (100 * p["idle_share_of_span"],
                           p["parts_ms"].get("%s:trunk" % kind, 0.0),
                           p["parts_ms"].get(TRUNK_BWD_PART, 0.0),
                           p["parts_ms"].get(K2_PRODUCTS_PART, 0.0))))
        del params
    out["k1_entries"] = cli_kernel_entries(
        torch, calls, kernels, on_path, flush, "phase 20 from pixels",
        where="px_train", phase="phase 20", kinds=("K1",))
    out["seconds"] = time.time() - t20
    log("phase 20 took %.1f s; by run %s" % (out["seconds"], json.dumps(
        out.get("split_s", {}))))
    require(not failed, "phase 20: %d of its runs failed: %s"
            % (len(failed), " | ".join(failed)))
    return out



# -- phase 21: mid-epoch resume, data parallel, reference checkpoints ------
PHASE21_S = 120.0             # phase 21's share of the script's time limit
MID_SAVE_STEPS = 2            # --midepoch_save_steps of (a)
MID_KILL = [2, 2]             # (a): killed once epoch 2's point after step 2
DP_B, DP_PX_B, DP_EVAL_B = 128, 64, 64   # (b): global batches
DP_STEPS = 3                  # (b): XE and SCST steps a run
DP_TOL = 1e-5                 # (b): first step's loss, gradients, BN stats
DP_LOSS3_TOL = 1e-4           # (b): the losses after DP_STEPS steps
# (b) from pixels: each BN layer's statistics against one process's run
# on the whole batch, whose convolutions round otherwise (at 2 x 32 against
# 64 the gap grows with depth: 1.2e-7 at the stem, 1.2e-5 at the last
# layer, measured on one H100); DP_TOL holds them against the float64
# statistics of the same activations over both processes
DP_PX_TOL = 1e-4
DP_PARTS = ["xe", "scst", "px", "eval"]  # (b): the runs of the gloo pair
REF_B = 384                   # (c): the converted checkpoint's beam decode
CHILD_S = 240                 # the longest a child of phase 21 may take
CHILD_THREADS = 2             # host threads of each child of phases 21, 23


def _sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _host_bytes(torch, tree):
    """A tree's tensors as one host bytes string (leaves in order)."""
    import numpy as np
    from simpleimagecaptionzoo_tpu_torch.engine.optim import tree_leaves
    parts = []
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.detach().cpu().contiguous()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            parts.append(t.numpy().tobytes())
        elif t is not None:
            parts.append(np.asarray(t).tobytes())
    return b"".join(parts)


def _grad_gap(torch, got, want):
    """(largest leaf's ||got - want||, the whole difference's norm) over
    the norm of the whole ``want`` gradient (every leaf).  A leaf's own
    norm is no yardstick: AoA's key-bias gradients are zero but for
    rounding."""
    from simpleimagecaptionzoo_tpu_torch.engine.optim import tree_leaves
    norm2, diff2, worst = 0.0, 0.0, 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        d = float(((g.double() - w.double()) ** 2).sum())
        norm2 += float((w.double() ** 2).sum())
        diff2 += d
        worst = max(worst, d)
    return math.sqrt(worst / norm2), math.sqrt(diff2 / norm2)


def dp_inputs(torch, seed, dev, dims):
    """(b)'s model, params and global batches, the same on every process
    (drawn from ``seed`` on ``dev``): AoADetection at ``dims`` (FULL on
    the card), XE captions of 3-22 tokens with the last 3 rows fillers,
    SCST references (7 of 6-20 ids an image) with their reward table (their
    own n-grams), BUTDSpatial from pixels, and the eval's box features."""
    import numpy as np
    from simpleimagecaptionzoo_tpu_torch.config import (ModelConfig,
                                                        TrainConfig,
                                                        load_model_config)
    from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
    from simpleimagecaptionzoo_tpu_torch.ops import cider
    gen = torch.Generator(device=dev).manual_seed(seed + 21)
    rng = np.random.default_rng(seed + 21)
    model = get_captioner(ModelConfig(**dims["aoa"]))
    params = model.init_params(gen)
    v, enc = model.config.vocab_size, model.config.enc_dim
    nb, b, t = dims["n_box"], dims["b"], dims["t"]
    caps = rng.integers(4, v, size=(b, t))
    caps[:, 0] = 1
    lens = rng.integers(3, t + 1, size=(b,))
    for i, n in enumerate(lens):
        caps[i, n - 1] = 2
        caps[i, n:] = 0
    weight = np.ones((b,), np.float32)
    weight[-3:] = 0.0

    def boxes(n):
        return {"bu_feats": torch.relu(torch.randn(n, nb, enc, generator=gen,
                                                   device=dev)),
                "bu_masks": torch.ones(n, nb, device=dev)}
    xe = {"visual": boxes(b), "captions": torch.from_numpy(caps).to(dev),
          "lengths": torch.from_numpy(lens).to(dev),
          "sample_weight": torch.from_numpy(weight).to(dev)}
    tc = TrainConfig()
    r, lr = tc.scst_num_refs, tc.scst_max_ref_len
    rlens = rng.integers(6, 21, size=(b, r))
    rids = np.zeros((b, r, lr), np.int64)
    for i in range(b):
        for j in range(r):
            rids[i, j, :rlens[i, j]] = rng.integers(4, v, rlens[i, j])
    table = cider.CiderDTable.from_ref_corpus(
        [[rids[i, j, :rlens[i, j]].tolist() for j in range(r)]
         for i in range(b)])
    td = table.device_arrays(dev)
    ref_ids = torch.from_numpy(rids).to(dev)
    ref_lens = torch.from_numpy(rlens).to(dev)
    scst = {"visual": boxes(b), "ref_ids": ref_ids, "ref_lens": ref_lens,
            "ref_norms": cider.ref_norms_device(td, table.probe, ref_ids,
                                                ref_lens),
            "sample_weight": torch.from_numpy(weight).to(dev)}
    px_model = get_captioner(load_model_config(
        os.path.join(HERE, "Configs", "Models", "BUTDSpatial.json"),
        vocab_size=v, **dims.get("px", {})))
    px_params = px_model.init_params(gen, include_cnn=True)
    px_state = px_model.init_model_state()
    pb = dims["px_b"]
    pcaps = torch.from_numpy(caps[:pb].copy()).to(dev)
    px = {"visual": {"img_tensors": photo_batch(torch, gen, pb, dims["side"],
                                                dev)},
          "captions": pcaps, "lengths": torch.from_numpy(lens[:pb]).to(dev)}
    ev = boxes(dims["eval_b"])
    return dict(model=model, params=params, xe=xe, scst=scst, td=td,
                probe=table.probe, px_model=px_model, px_params=px_params,
                px_state=px_state, px=px, eval=ev)


def _rows(torch, tree, rank, world):
    if isinstance(tree, dict):
        return {k: _rows(torch, v, rank, world) for k, v in tree.items()}
    per = tree.shape[0] // world
    return tree[rank * per:(rank + 1) * per]


def dp_run(torch, inp, dev, rank, world, parts, lr=TRAIN_LR, held=None,
           profiled=False, gate=None):
    """(b)'s runs as process ``rank`` of ``world`` (a process group when
    ``world`` > 1 or NCCL; none for the reference), each on this process's
    rows of the global batches of :func:`dp_inputs`: ``xe`` (Adam, dropout
    at the published rates, scheduled sampling at 0.25), ``scst`` (its
    rollout draws), ``px`` (BUTDSpatial XE from pixels, a float32
    train-mode trunk, BN_MOMENTUM 1 so the new statistics are the batch's;
    each BN layer's beside the float64 statistics of its own activations
    over every process),
    ``eval`` (beam 3, float32, the ids all-gathered).  The first XE and
    SCST step's gradient (as the step hands it to its optimizer) is kept;
    ``held`` (a list) collects the calls of the first steps and the decode
    that broke their hold (engine/holds.held_calls); with ``profiled`` the
    last two steps run under torch.profiler.  The runs go px, eval, XE's
    and SCST's first steps, then their timed steps; ``gate`` (a callable)
    is called once before the first timed steps, which can so wait for a
    quiet card.  -> the readings."""
    import zlib
    import numpy as np
    from simpleimagecaptionzoo_tpu_torch import parallel
    from simpleimagecaptionzoo_tpu_torch.engine import holds, optim, steps
    from simpleimagecaptionzoo_tpu_torch.engine.state import TrainState
    from simpleimagecaptionzoo_tpu_torch.models import resnet
    from torch.profiler import ProfilerActivity, profile
    out = {"held_calls": 0}

    def held_ctx(shapes):
        if held is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(holds.held_calls(held))
        stack.enter_context(holds.recording_shapes(shapes))
        return stack

    def capturing(tx):
        handed = []

        def update(g, s, p):
            if not handed:
                handed.append(optim.tree_map(lambda t: t.detach().clone(), g))
            return tx.update(g, s, p)
        return optim.GradientTransformation(tx.init, update), handed

    def train(kind, make, batch, call):
        """The first step (its calls held); -> the rest, a callable."""
        tx, handed = capturing(optim.make_grad_transform("Adam", 0.1))
        step = make(tx)
        state = TrainState.create(inp["params"], tx)
        gen = torch.Generator(device=dev).manual_seed(7)
        losses, shapes = [], []
        with held_ctx(shapes):
            state, met = call(step, state, batch, gen)
        out["held_calls"] += len(shapes)
        losses.append(float(met["loss"]))
        _sync(torch)
        return lambda: timed(kind, step, state, batch, gen, call, losses,
                             handed)

    def timed(kind, step, state, batch, gen, call, losses, handed):
        if gate is not None and not out.get("gated"):
            gate()
            out["gated"] = True
        prof = None
        if profiled:
            acts = [ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
        t0 = time.perf_counter()
        for _ in range(DP_STEPS - 1):
            state, met = call(step, state, batch, gen)
            losses.append(float(met["loss"]))
        _sync(torch)
        secs = time.perf_counter() - t0
        res = {"losses": losses, "grads": handed[0],
               "ms_per_step": 1e3 * secs / (DP_STEPS - 1),
               "params_crc": zlib.crc32(_host_bytes(torch, state.params))}
        if prof is not None:
            prof.__exit__(None, None, None)
            cpu_t = torch.autograd.DeviceType.CPU
            res["all_reduce_ms_per_step"] = sum(
                e - s for ev, name, s, e in raw_events(
                    torch, prof.profiler.kineto_results)
                if name == "parallel.all_reduce_sum"
                and ev.device_type() == cpu_t) / 1e3 / (DP_STEPS - 1)
        if world > 1 or parallel.process_count() > 1:
            res["params_agree"] = parallel.processes_agree(np.array(
                [res["params_crc"]], np.int64))
        out[kind] = res

    if "px" in parts:
        saved = (resnet.BN_MOMENTUM, resnet.apply.__defaults__)
        resnet.BN_MOMENTUM = 1.0
        resnet.apply.__defaults__ = (torch.float32, False)
        try:
            m, p = inp["px_model"], inp["px_params"]
            tx = optim.make_grad_transform("Adam", 0.1)
            step = steps.make_xe_train_step(m, tx, m.param_labels(p), 0.1,
                                            ss_active=False, device=dev)
            shapes, exact = [], []
            bn = resnet._bn

            def exact_bn(x, pp, st, train=False):
                """resnet._bn, and the gap of its statistics from the
                float64 ones of the same activations over every process"""
                y, new_st = bn(x, pp, st, train)
                if train:
                    with torch.no_grad():
                        xd = x.detach().double()
                        n = (x.shape[0] * x.shape[2] * x.shape[3]
                             * parallel.process_count())
                        mean = parallel.global_sum(xd.sum(dim=(0, 2, 3))) / n
                        var = parallel.global_sum(((xd - mean[:, None, None])
                                                   ** 2).sum(dim=(0, 2, 3)))
                        var = var / max(n - 1, 1)      # the unbiased one
                        exact.append(max(
                            float((new_st[k].double() - w).norm() / w.norm())
                            for k, w in (("mean", mean), ("var", var))))
                return y, new_st
            resnet._bn = exact_bn
            try:
                with held_ctx(shapes):
                    new, met = step(TrainState.create(p, tx,
                                                      inp["px_state"]),
                                    _rows(torch, inp["px"], rank, world),
                                    torch.Generator(device=dev).manual_seed(
                                        7), 0.0, lr, lr)
            finally:
                resnet._bn = bn
            out["held_calls"] += len(shapes)
            out["px"] = {"loss": float(met["loss"]), "exact_gap": max(exact),
                         "n_bn": len(exact),
                         "stats": new.model_state["cnn_stats"]}
            if world > 1:
                out["px"]["stats_agree"] = parallel.processes_agree(
                    np.array([zlib.crc32(_host_bytes(
                        torch, new.model_state["cnn_stats"]))], np.int64))
        finally:
            resnet.BN_MOMENTUM, resnet.apply.__defaults__ = saved
    if "eval" in parts:
        fn = steps.make_beam_decode(inp["model"], beam_size=BEAM,
                                    max_steps=MAX_LEN, device=dev)
        shapes = []
        with held_ctx(shapes):
            ids = fn(inp["params"], {}, _rows(torch, inp["eval"], rank,
                                              world))
        out["held_calls"] += len(shapes)
        ids = parallel.host_read(ids)
        out["eval"] = {"ids": ids}
        if world > 1:
            out["eval"]["ids_agree"] = parallel.processes_agree(ids)
    labels = inp["model"].param_labels(inp["params"])
    rest = []
    if "xe" in parts:
        rest.append(train("xe", lambda tx: steps.make_xe_train_step(
            inp["model"], tx, labels, 0.1, ss_active=True, device=dev),
            _rows(torch, inp["xe"], rank, world),
            lambda st, s, b, g: st(s, b, g, TRAIN_SS, lr, 0.0)))
    if "scst" in parts:
        rest.append(train("scst", lambda tx: steps.make_scst_train_step(
            inp["model"], tx, labels, inp["td"], inp["probe"], MAX_LEN,
            device=dev), _rows(torch, inp["scst"], rank, world),
            lambda st, s, b, g: st(s, b, g, lr, 0.0)))
    # the first (held) steps of both before the gate, the timed ones after
    for run in rest:
        run()
    return out


def dp_compare(torch, got, ref, tag):
    """(b)'s gates: ``got`` (a data-parallel run's readings on process 0)
    against ``ref`` (one process on the whole batches)."""
    meas = {}
    for kind in ("xe", "scst"):
        if kind not in got:
            continue
        g, r = got[kind], ref[kind]
        worst, whole = _grad_gap(torch, g["grads"], r["grads"])
        d1 = abs(g["losses"][0] - r["losses"][0])
        d3 = max(abs(a - b) for a, b in zip(g["losses"], r["losses"]))
        require(d1 <= DP_TOL * abs(r["losses"][0]) and worst <= DP_TOL
                and d3 <= DP_LOSS3_TOL * abs(r["losses"][0])
                and g.get("params_agree", True),
                "%s %s: first loss %.7g against %.7g, a leaf's gradient %.3g "
                "and the whole %.3g of the gradient's norm off (tol %g), the "
                "losses of %d steps up to %.3g apart, params agree %s"
                % (tag, kind, g["losses"][0], r["losses"][0], worst, whole,
                   DP_TOL, DP_STEPS, d3, g.get("params_agree")))
        meas[kind] = dict(first_loss=g["losses"][0],
                          ref_first_loss=r["losses"][0],
                          grad_leaf_gap=worst, grad_gap=whole,
                          loss_gap_3=d3, ms_per_step=g["ms_per_step"],
                          steps_per_s=1e3 / g["ms_per_step"],
                          all_reduce_ms_per_step=g.get(
                              "all_reduce_ms_per_step"))
    if "px" in got:
        from simpleimagecaptionzoo_tpu_torch.engine.optim import tree_leaves
        gaps = []
        for a, b in zip(tree_leaves(got["px"]["stats"]),
                        tree_leaves(ref["px"]["stats"])):
            gaps.append(float((a.double() - b.double()).norm()
                              / b.double().norm().clamp_min(1e-30)))
        dl = abs(got["px"]["loss"] - ref["px"]["loss"])
        require(got["px"]["exact_gap"] <= DP_TOL and max(gaps) <= DP_PX_TOL
                and dl <= DP_TOL * abs(ref["px"]["loss"])
                and got["px"]["stats_agree"],
                "%s px: BN batch statistics up to %.3g of their norm from the "
                "float64 ones of the same activations (tol %g), up to %.3g "
                "from one process's (tol %g; in the trunk's order: %s), loss "
                "%.7g against %.7g, the processes' running statistics agree "
                "%s" % (tag, got["px"]["exact_gap"], DP_TOL, max(gaps),
                        DP_PX_TOL, ["%.2g" % g for g in gaps],
                        got["px"]["loss"], ref["px"]["loss"],
                        got["px"]["stats_agree"]))
        meas["px"] = dict(exact_gap=got["px"]["exact_gap"],
                          n_bn=got["px"]["n_bn"], stats_gap=max(gaps),
                          stats_gap_first=gaps[0], n_stats=len(gaps),
                          loss=got["px"]["loss"], ref_loss=ref["px"]["loss"])
    if "eval" in got:
        same = bool((got["eval"]["ids"] == ref["eval"]["ids"]).all())
        require(got["eval"]["ids_agree"] and same,
                "%s eval: the processes' captions agree %s, equal to one "
                "process's %s" % (tag, got["eval"]["ids_agree"], same))
        meas["eval"] = dict(rows=int(got["eval"]["ids"].shape[0]))
    return meas


def dp_child(argv):
    """``chip_smoke.py --phase21-dp CASE RANK WORLD STORE OUT``: one
    process of (b) on the card (cuda:0).  Process 0, before the group
    starts, also runs the one-process reference on the whole batches (its
    kernel calls recorded); then the group (CASE's backend, a FileStore at
    STORE) runs the case's parts, every kernel call of the first steps and
    the decode held against its plain version, its timed steps once the
    parent has written CASE's ``go`` file, and process 0 gates them
    against the reference, makes the recorded calls' entries of the
    kernels line (``where`` dist) and writes its readings to OUT (json)."""
    case_path, rank, world, store, out_path = argv
    rank, world = int(rank), int(world)
    with open(case_path) as f:
        case = json.load(f)
    child_ready("script read")
    import torch
    from simpleimagecaptionzoo_tpu_torch import parallel
    from simpleimagecaptionzoo_tpu_torch.device import resolve_device
    child_ready("torch imported")
    _wait_for(case["start"], "phase 21 (b): no start")
    dev = resolve_device(case["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    inp = dp_inputs(torch, case["seed"], dev, case["dims"])
    child_ready("inputs on the device")
    ref, calls = None, KernelCalls()
    if rank == 0:
        with calls.recording(torch):
            ref = dp_run(torch, inp, dev, 0, 1, case["parts"])
    if case["profiled"]:
        # the profiler's first start sets up its tracing for seconds: not
        # inside a timed step, where the other process would wait for it
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if dev.type == "cuda" else [])
        with profile(activities=acts):
            torch.ones(1, device=dev).add_(1)
    parallel.configure_collective_timeout(90)
    parallel.init_process_group(case["backend"], world, rank,
                                store=torch.distributed.FileStore(store,
                                                                  world))
    def gate():
        """wait for the parent's word that the card is quiet"""
        _wait_for(case["go"], "phase 21 (b): no word")

    broken = []
    got = dp_run(torch, inp, dev, rank, world, case["parts"], held=broken,
                 profiled=case["profiled"], gate=gate)
    require(not broken, "phase 21 (b) process %d: %d kernel calls broke "
            "their hold (first: %s)" % (rank, len(broken), broken[:1]))
    res = {"held_calls": got["held_calls"], "rank": rank}
    if rank == 0:
        tag = "phase 21 (b) %s x %d" % (case["backend"], world)
        if case.get("bits"):
            # one process under the group against none: the same bits
            for kind in ("xe",):
                same = (got[kind]["losses"][0] == ref[kind]["losses"][0]
                        and _tree_bits_equal(torch, got[kind]["grads"],
                                             ref[kind]["grads"]))
                require(same, "%s %s: the first step's loss or gradient "
                        "differs from the run without a process group"
                        % (tag, kind))
            res["bit_identical"] = True
        else:
            res["measured"] = dp_compare(torch, got, ref, tag)
    torch.distributed.destroy_process_group()
    if rank == 0 and case.get("entries") and dev.type == "cuda":
        # an entry for each K1 and K2 launch shape of the one-process run
        # (K2's backward has (a)'s at these widths), made once the group's
        # work is done
        flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32,
                            device=dev)
        kernels, on_path = {}, set()
        cli_kernel_entries(torch, calls, kernels, on_path, flush,
                           "phase 21 dist", where="dist", phase="phase 21",
                           kinds=("K1", "K2"))
        res["kernels"] = kernels
    with open(out_path, "w") as f:
        json.dump(res, f, default=float)
    return 0


def _state_digest(torch, eng):
    """What (a) compares of a finished run: sha1 of its params' bytes and
    of its optimizer state's (the moments and the count, at the last
    epoch's end), the step count, its CIDEr history and its resume
    points' records."""
    st = eng.last_state
    with open(eng.ckpt._histories(eng._scst_run)) as f:
        cider = json.load(f)["cider_his"]
    return {"params": _sha1(torch, eng.tree["params"]),
            "opt": _sha1(torch, st.opt_state),
            "step": int(st.step), "cider": cider,
            "saves": list(eng.midepoch_saves)}


def _sha1(torch, tree):
    """sha1 of :func:`_host_bytes` of ``tree``, leaf by leaf."""
    import hashlib
    import numpy as np
    from simpleimagecaptionzoo_tpu_torch.engine.optim import tree_leaves
    h = hashlib.sha1()
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.detach().cpu().contiguous()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            h.update(t.numpy().reshape(-1).view(np.uint8))
        elif t is not None:
            h.update(np.asarray(t).tobytes())
    return h.hexdigest()


def run_cli(torch, argv, scst):
    """The port's CLI in this process (the current directory holds the
    dataset) -> its engine."""
    from simpleimagecaptionzoo_tpu_torch import main as cli
    from simpleimagecaptionzoo_tpu_torch.engine import model_engines
    made, orig = [], model_engines.get_engine

    def get_engine(*a, **kw):
        made.append(orig(*a, **kw))
        made[-1]._scst_run = scst
        return made[-1]
    model_engines.get_engine = get_engine
    try:
        rc = cli.main(cli.build_argparser().parse_args(argv))
    finally:
        model_engines.get_engine = orig
    _sync(torch)
    require(rc == 0 and made, "phase 21 (a): main returned %s" % rc)
    return made[0]


def cli_child(argv):
    """``chip_smoke.py --phase21-cli SPEC``: the port's CLI (SPEC's argv, in
    SPEC's directory), once SPEC's ``ready`` file exists (the parent writes
    the dataset while its children start).  With SPEC's ``kill`` (epoch,
    steps done) the process
    SIGKILLs itself once that mid-epoch resume point has committed (its
    background write joined): the interruption of (a); else it writes the
    finished run's :func:`_state_digest` to SPEC's ``out``."""
    import signal
    with open(argv[0]) as f:
        spec = json.load(f)
    os.chdir(spec["cwd"])
    child_ready("script read")
    import torch
    from simpleimagecaptionzoo_tpu_torch.engine.engine import Engine
    child_ready("torch imported")
    if spec.get("kill"):
        save = Engine._save_midepoch

        def save_then_die(self, state, epoch, steps_done, **kw):
            save(self, state, epoch, steps_done, **kw)
            if [epoch, steps_done] == spec["kill"]:
                self._midepoch_join()
                _sync(torch)
                os.kill(os.getpid(), signal.SIGKILL)
        Engine._save_midepoch = save_then_die
    _wait_for(spec["ready"], "phase 21 (a): no dataset")
    eng = run_cli(torch, spec["argv"], spec["scst"])
    if spec.get("kill"):
        return 3                 # the kill never came
    with open(spec["out"], "w") as f:
        json.dump(_state_digest(torch, eng), f)
    return 0


def _wait_for(path, what):
    """Wait (at most CHILD_S) for the parent to write ``path``."""
    t0 = time.time()
    while not os.path.exists(path):
        require(time.time() - t0 < CHILD_S, what)
        time.sleep(0.05)


def _child(args, log_path):
    """A child process of this script (its output to ``log_path``),
    CHILD_THREADS host threads for its operators (phase 21 runs up to six
    at once on the card's host)."""
    with open(log_path, "w") as log_f:
        return subprocess.Popen([sys.executable, os.path.abspath(__file__)]
                                + args, stdout=log_f,
                                stderr=subprocess.STDOUT, cwd=HERE,
                                env=dict(os.environ,
                                         OMP_NUM_THREADS=str(CHILD_THREADS),
                                         CHIP_SMOKE_SPAWNED=repr(time.time())))


def child_ready(what):
    """Log a child's seconds since its parent spawned it (``what``: the
    stage reached), for :func:`startup_seconds`."""
    t0 = os.environ.get("CHIP_SMOKE_SPAWNED")
    if t0:
        log("child start-up: %s %.2f s after the spawn"
            % (what, time.time() - float(t0)))


def startup_seconds(log_paths):
    """{stage: [seconds, ...]} of the children's :func:`child_ready`
    lines in ``log_paths``."""
    out = {}
    for path in log_paths:
        with open(path) as f:
            for m in re.finditer(r"child start-up: (.+) ([0-9.]+) s after",
                                 f.read()):
                out.setdefault(m.group(1), []).append(float(m.group(2)))
    return out


def _wait(proc, log_path, what, timeout, want=0, phase="phase 21"):
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    if rc != want:
        with open(log_path) as f:
            sys.stdout.write(f.read()[-6000:])
    require(rc == want, "%s %s: the child exited %s, not %s"
            % (phase, what, rc, want))


def _run_dir(root, name, ds):
    """A directory for one CLI run of (a): the dataset's Configs, Data and
    modified_annotations linked in; its own CheckPoints and results."""
    d = os.path.join(root, name)
    os.makedirs(d)
    for sub in ("Configs", "Data", "modified_annotations"):
        os.symlink(os.path.join(ds, sub), os.path.join(d, sub))
    return d


def drive_phase21(torch, args, dev, flush, kernels, on_path, model, params,
                  dims=None, models=None, gpu="0"):
    """Phase 21.  (a) Mid-epoch resume through the port's CLI (phase 18's
    dataset, AoADetection at full width, B=128, 4 steps an epoch,
    --midepoch_save_steps 2, 2 epochs): XE float32 and bf16 and SCST
    float32, each run uninterrupted in a child process and again in another
    one SIGKILLed once epoch 2's resume point after step 2 committed (the
    six children at once, started while the dataset is written), each
    killed run resumed here with --start_from checkpoint once its child is
    gone (beside the uninterrupted children still running): the final
    params, the optimizer's moments and the step count bit-identical (sha1
    of their bytes, :func:`_state_digest`), the CIDEr history equal; the
    saves' ms on the loop and in the background and their bytes (the
    uninterrupted children's, six processes sharing the card).  (b) Data
    parallel (children started beside (a)'s, on cuda:0 once (a)'s
    children are gone, beside (a)'s resumes; their timed steps wait until
    the
    parent is done with those, (c)'s timed decode and the entries, and has
    timed one process's steps at (b)'s shapes alone): 2 processes under
    gloo at 2 x 64 against one
    process x 128 (XE with scheduled sampling,
    SCST; 3 steps each), BUTDSpatial XE from pixels at 2 x 32 and eval
    beam 3 at 2 x 32 (:func:`dp_compare`); 1 process under NCCL, its first
    XE step bit-identical to the run without a group.  (c) While (a)'s
    children run, a reference-shaped AoADetection state_dict (random
    weights from --seed) through tools/convert_reference_checkpoint,
    decoded beam 3 bf16 at B=384 with every kernel call held and phase 9's
    gate (:func:`drive_reference`), and back through
    tools/export_reference_checkpoint: the same bits; its decode timed
    once (a) is done.  Every kernel call
    of the resumed runs, of (b)'s one-process run and of (c)'s decode is
    recorded (``where`` mid, dist, ref) and gets its entry.

    ``dims`` (the model, batch and image sizes of (b)), ``models`` (the
    model configs of (a)) and ``gpu`` (--gpu_id of the CLI and the tools)
    default to the card's run at full width; a rehearsal on the CPU at
    small sizes passes its own."""
    import signal
    import tempfile
    t_phase = time.time()
    root = tempfile.mkdtemp(prefix="chip_smoke_p21_")
    cwd = os.getcwd()
    out = {"a": {}, "b": {}, "c": {}}
    rec = {w: KernelCalls() for w in ("mid", "ref")}
    kids, procs = {}, []
    models = models or os.path.join(HERE, "Configs", "Models") + os.sep
    try:
        # -- (a): six children at once, started while the dataset is
        # written (each waits for ``ready``), then each killed run resumed
        # here once its child is gone, beside the uninterrupted ones
        t_a = time.time()
        ds = os.path.join(root, "ds")
        os.makedirs(ds)
        ready = os.path.join(root, "ds_ready")
        base = ["--dataset", "Flickr8K", "--model_type", "AoADetection",
                "--model_config_root", models, "--use_bu", "fixed",
                "--train_batch_size", str(CLI_B), "--scst_train_batch_size",
                str(CLI_B), "--eval_batch_size", str(CLI_EVAL_B),
                "--tqdm_visible", "False", "--seed", str(args.seed),
                "--midepoch_save_steps", str(MID_SAVE_STEPS), "--gpu_id",
                gpu]
        xe = ["--operation", "train", "--num_epochs", "2"]
        runs = {"xe_f32": base + xe,
                "xe_bf16": base + xe + ["--train_dtype", "bfloat16"],
                "scst_f32": base + ["--operation", "scst_train",
                                    "--scst_num_epochs", "2"]}
        for name in runs:
            for kind in ("ref", "kill"):
                d = _run_dir(root, "%s_%s" % (name, kind), ds)
                spec = os.path.join(root, "%s_%s.json" % (name, kind))
                with open(spec, "w") as f:
                    json.dump({"cwd": d, "argv": runs[name],
                               "scst": name.startswith("scst"),
                               "kill": MID_KILL if kind == "kill" else None,
                               "out": d + ".digest.json", "ready": ready}, f)
                log_path = d + ".log"
                kids[name, kind] = (log_path, _child(
                    ["--phase21-cli", spec], log_path))
        # -- (b): the gloo pair and the NCCL process, started beside (a)'s
        # children to import torch; they take the card once (a)'s six
        # children are gone (``start``: ten processes do not fit on it),
        # and their timed steps wait for the parent's word (a quiet card)
        go, start = os.path.join(root, "go"), os.path.join(root, "start")
        dims = dims or dict(aoa=FULL, n_box=N_BOX, b=DP_B, t=TRAIN_T,
                            px_b=DP_PX_B, side=224, eval_b=DP_EVAL_B)
        groups = [("gloo", 2, DP_PARTS, False)]
        if dev.type == "cuda":
            groups.append(("nccl", 1, ["xe"], True))
        t_b = time.time()
        for name, world, parts, bits in groups:
            case = os.path.join(root, name + ".json")
            with open(case, "w") as f:
                json.dump({"seed": args.seed, "dims": dims,
                           "parts": parts, "backend": name,
                           "bits": bits, "entries": name == "gloo",
                           "device": "cuda:0" if dev.type == "cuda"
                           else "cpu", "profiled": name == "gloo",
                           "go": go, "start": start}, f)
            for r in range(world):
                log_path = os.path.join(root, "%s%d.log" % (name, r))
                res_path = os.path.join(root, "%s%d.json" % (name, r))
                procs.append((name, r, res_path, log_path, _child(
                    ["--phase21-dp", case, str(r), str(world),
                     os.path.join(root, name + ".store"), res_path],
                    log_path)))
        write_cli_dataset(torch, ds, args.seed, dev)
        with open(ready, "w"):
            pass
        out["dataset_s"] = time.time() - t_phase
        # -- (c), while (a)'s children run; its decode is timed later, on a
        # quiet card
        t_c = time.time()
        with rec["ref"].recording(torch):
            out["c"], time_c = drive_reference(torch, args, dev, root, model,
                                               params, rec["ref"], gpu)
        out["c"]["seconds"] = time.time() - t_c
        if dev.type == "cuda":
            torch.cuda.empty_cache()        # (c)'s blocks, for the children

        def start_b():
            if not os.path.exists(start) and all(
                    proc.poll() is not None for _, proc in kids.values()):
                out["a"]["children_s"] = time.time() - t_a
                with open(start, "w"):
                    pass

        digests = {}
        for name, argv in runs.items():
            log_path, proc = kids[name, "kill"]
            _wait(proc, log_path, "(a) %s kill" % name, CHILD_S,
                  want=-signal.SIGKILL)
            start_b()
            scst = name.startswith("scst")
            d = os.path.join(root, name + "_kill")
            with open(os.path.join(
                    d, "CheckPoints", "Model_AoADetection_Dataset_Flickr8K",
                    "cp", "midepoch_%sstate.json" % ("scst_" if scst
                                                     else ""))) as f:
                m = json.load(f)
            require([m["epoch"], m["steps_done"]] == MID_KILL,
                    "phase 21 (a) %s: the resume point on disk is %s"
                    % (name, m))
            os.chdir(d)
            t_r = time.time()
            try:
                with rec["mid"].recording(torch):
                    eng = run_cli(torch, argv + ["--start_from",
                                                 "checkpoint"], scst)
                digests[name] = _state_digest(torch, eng)
            finally:
                os.chdir(cwd)
            del eng
            out["a"][name] = dict(resume_s=time.time() - t_r)
            start_b()
        for name, argv in runs.items():
            log_path, proc = kids[name, "ref"]
            _wait(proc, log_path, "(a) %s ref" % name, CHILD_S)
            start_b()
            got = digests[name]
            with open(os.path.join(root, name + "_ref.digest.json")) as f:
                want = json.load(f)
            same = {k: got[k] == want[k]
                    for k in ("params", "opt", "step", "cider")}
            require(all(same.values()), "phase 21 (a) %s: the resumed run "
                    "against the uninterrupted one, equal: %s" % (name, same))
            saves = want["saves"]
            out["a"][name].update(
                resumed_bit_identical=True, steps=want["step"],
                saves=saves, save_loop_ms=[x["loop_ms"] for x in saves],
                save_background_ms=[x.get("background_ms") for x in saves],
                checkpoint_bytes=[x.get("bytes") for x in saves])
            log("phase 21 (a) %s: killed at epoch %d step %d, resumed: "
                "params, moments, step %d and CIDEr history identical to "
                "the uninterrupted run's; its saves %s" % (
                    name, MID_KILL[0], MID_KILL[1], want["step"],
                    json.dumps(saves)))
        out["a"]["child_startup_s"] = startup_seconds(
            [log_path for log_path, _ in kids.values()])
        out["a"]["seconds"] = time.time() - t_a
        log("phase 21 (a) took %.1f s" % out["a"]["seconds"])

        out["c"]["captions_per_s"] = time_c()
        log("phase 21 (c): the converted checkpoint's beam 3 bf16 at B=%d: "
            "%.1f captions/s" % (REF_B, out["c"]["captions_per_s"]))

        # every kernel call of (a)'s resumes and (c): an entry for each
        # launch shape (kernels launch on the card alone)
        t_e = time.time()
        out["kernel_entries"] = []
        for where, calls in rec.items():
            if dev.type != "cuda":
                continue
            require(calls.count, "phase 21: no kernel call recorded (%s)"
                    % where)
            out["kernel_entries"] += cli_kernel_entries(
                torch, calls, kernels, on_path, flush, "phase 21 " + where,
                where=where, phase="phase 21")
        # one process's XE and SCST steps at (b)'s shapes, timed alone on
        # the card, then the word: (b)'s timed steps run
        out["entries_s"] = time.time() - t_e
        inp = dp_inputs(torch, args.seed, dev, dims)
        alone = dp_run(torch, inp, dev, 0, 1, ["xe", "scst"])
        del inp
        out["b"]["alone_s"] = time.time() - t_e - out["entries_s"]
        with open(go, "w"):
            pass
        t_go = time.time()
        for name, r, res_path, log_path, proc in procs:
            _wait(proc, log_path, "(b) %s process %d" % (name, r),
                  CHILD_S)
            with open(res_path) as f:
                got = json.load(f)
            require(got["held_calls"] > 0 or dev.type != "cuda",
                    "phase 21 (b) %s process %d held no kernel call"
                    % (name, r))
            for ename, entry in got.pop("kernels", {}).items():
                kernels[ename] = entry
                on_path.add(ename)
            out["b"].setdefault(name, {})[r] = got
        out["b"]["seconds"] = time.time() - t_b
        out["b"]["after_go_s"] = time.time() - t_go
        out["b"]["child_startup_s"] = startup_seconds(
            [p[3] for p in procs])
        for kind in ("xe", "scst"):
            m = out["b"]["gloo"][0]["measured"][kind]
            m["one_process_ms_per_step"] = alone[kind]["ms_per_step"]
            m["two_over_one"] = (alone[kind]["ms_per_step"]
                                 / m["ms_per_step"])
        log("phase 21 (b): %s" % json.dumps(out["b"]))

    finally:
        os.chdir(cwd)
        # a phase that failed leaves no child behind
        for proc in [k[1] for k in kids.values()] + [q[4] for q in procs]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.time() - t_phase
    log("phase 21 took %.1f s (dataset %.1f, a %.1f, b %.1f, c %.1f); "
        "a: its children gone at %.1f, start-up %s; entries %.1f, "
        "b alone %.1f, b after the word %.1f, start-up %s"
        % (out["seconds"], out["dataset_s"], out["a"]["seconds"],
           out["b"]["seconds"], out["c"]["seconds"], out["a"]["children_s"],
           out["a"]["child_startup_s"], out["entries_s"],
           out["b"]["alone_s"], out["b"]["after_go_s"],
           out["b"]["child_startup_s"]))
    require(out["seconds"] <= PHASE21_S, "phase 21 took %.1f s, over its "
            "%.0f s" % (out["seconds"], PHASE21_S))
    return out


def reference_state_dict(torch, model, params, seed):
    """A reference-shaped state_dict of ``model`` (the keys and shapes the
    reference's modules hold, convert_reference.export_state_dict's) with
    random float32 weights from ``seed``, drawn as the reference's modules
    draw them at init: a Linear's weight and bias, and weight_norm's v,
    U(-1/sqrt(in), 1/sqrt(in)) with g each row's norm; an LSTMCell's
    U(-1/sqrt(H), 1/sqrt(H)); the embedding U(-0.1, 0.1) (AoA's re-init);
    LayerNorm gains 1 and biases 0; the prediction head's bias 0."""
    from simpleimagecaptionzoo_tpu_torch import convert_reference as CR
    shapes = {k: v.shape for k, v in CR.export_state_dict(
        params, None, model.config.model_type).items()}
    gen = torch.Generator().manual_seed(seed + 2121)

    def uniform(shape, bound):
        return (torch.rand(shape, generator=gen) * 2 - 1) * bound

    sd = {}
    for k in sorted(shapes):
        shape, pre = shapes[k], k.rsplit(".", 1)[0]
        if k.endswith("weight_g"):
            continue
        if pre + ".gain" in shapes:                  # a LayerNorm
            sd[k] = torch.ones(shape) if k.endswith(".gain") \
                else torch.zeros(shape)
        elif "embed" in k:
            sd[k] = uniform(shape, 0.1)
        elif k.endswith(("_ih", "_hh")):             # an LSTMCell
            sd[k] = uniform(shape, 1 / math.sqrt(shape[0] // 4))
        elif k == "decoder.predict.bias":
            sd[k] = torch.zeros(shape)
        else:                                        # a Linear
            w = shapes.get(pre + ".weight", shapes.get(pre + ".weight_v"))
            sd[k] = uniform(shape, 1 / math.sqrt(w[1]))
    for k in shapes:
        if k.endswith("weight_g"):
            sd[k] = sd[k[:-1] + "v"].norm(dim=1, keepdim=True)
    return sd


def drive_reference(torch, args, dev, root, model, params, calls, gpu="0"):
    """(c): :func:`reference_state_dict` of AoADetection at full width,
    saved as a reference ``.pth``, through
    ``tools.convert_reference_checkpoint.main`` (--gpu_id 0) into the
    port's checkpoint, loaded onto the card, decoded beam 3 bf16 at B=384
    (10-36 valid boxes) through the kernels: once with the plain versions,
    once through the kernels (recorded in ``calls``), once with every kernel
    call held against its plain version, and phase 9's gate (the kernel
    run's winners rescored by the plain step within holds.beam_tol of the
    plain run's); then ``tools.export_reference_checkpoint.main`` writes
    it back, and the two state_dicts are the same bits.  -> (the
    readings, a callable that times the decode once more: captions/s)."""
    from simpleimagecaptionzoo_tpu_torch import STA_ID
    from simpleimagecaptionzoo_tpu_torch.engine import holds, steps
    from simpleimagecaptionzoo_tpu_torch.engine.checkpoint import \
        CheckpointManager
    from simpleimagecaptionzoo_tpu_torch.tools import (
        convert_reference_checkpoint, export_reference_checkpoint)
    sd = reference_state_dict(torch, model, params, args.seed)
    src = os.path.join(root, "Captioner_cp.pth")
    torch.save(sd, src)
    ck = os.path.join(root, "ref_ckpt")
    with calls.paused():
        rc = convert_reference_checkpoint.main(
            ["--pth", src, "--model_type", "AoADetection", "--dataset",
             "Flickr8K", "--checkpoint_root", ck, "--gpu_id", gpu])
    require(rc == 0, "phase 21 (c): the converter returned %s" % rc)
    tree, _, _ = CheckpointManager("AoADetection", "Flickr8K",
                                   root=ck).load(
        {"params": params, "model_state": {"cnn_stats": None}})
    require(tree is not None, "phase 21 (c): no converted checkpoint")
    prm = tree["params"]
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2122)
    cfg = model.config
    valid = torch.randint(min(10, cfg.max_bu_len), cfg.max_bu_len + 1,
                          (REF_B,), generator=gen, device=dev)
    masks = (torch.arange(cfg.max_bu_len, device=dev)[None]
             < valid[:, None]).float()
    visual = {"bu_feats": torch.relu(torch.randn(
        REF_B, cfg.max_bu_len, cfg.enc_dim, generator=gen, device=dev))
        * masks[..., None], "bu_masks": masks}
    bf = torch.bfloat16
    fn = steps.make_beam_decode(model, beam_size=BEAM, max_steps=MAX_LEN,
                                dtype=bf, device=dev)
    with calls.paused(), holds.plain_versions():
        ref_ids = fn(prm, {}, visual)
    ids = fn(prm, {}, visual)
    _sync(torch)
    broken = []
    with calls.paused(), holds.held_calls(broken):
        fn(prm, {}, visual)
        margin = holds.rescored_margin(model, prm, visual, ids, ref_ids, bf,
                                       dev, {})
    _sync(torch)
    require(not broken, "phase 21 (c): %d kernel calls of the converted "
            "checkpoint's decode broke their hold (first: %s)"
            % (len(broken), broken[:1]))
    tol = holds.beam_tol(bf, MAX_LEN)
    passed, rows_same = holds.beam_gate(False, ids, ref_ids, margin, tol)
    require(passed and bool((ids[:, 0] == STA_ID).all()),
            "phase 21 (c): the converted checkpoint's beam-3 bf16 winners "
            "score %.4f below the plain run's (tol %.4f)"
            % (-float(margin.min()), tol))
    mc = os.path.join(root, "AoADetection.json")
    with open(mc, "w") as f:
        json.dump({k: getattr(cfg, k) for k in FULL if k != "vocab_size"}, f)
    back_path = os.path.join(root, "back.pth")
    with calls.paused():
        rc = export_reference_checkpoint.main(
            ["--model_config", mc, "--vocab_size", str(cfg.vocab_size),
             "--dataset", "Flickr8K", "--checkpoint_root", ck, "--out",
             back_path, "--gpu_id", gpu])
    require(rc == 0, "phase 21 (c): the exporter returned %s" % rc)
    back = torch.load(back_path, map_location="cpu", weights_only=True)
    differ = [k for k in sd if k not in back or back[k].dtype != sd[k].dtype
              or not torch.equal(back[k], sd[k])]
    require(sorted(back) == sorted(sd) and not differ,
            "phase 21 (c): the exported state_dict differs from the one "
            "converted: %d keys differ (%s), %d keys against %d"
            % (len(differ), differ[:3], len(back), len(sd)))
    n = sum(int(v.numel()) for v in sd.values())
    log("phase 21 (c): a reference state_dict of %d keys (%d parameters) "
        "converted, beam 3 bf16 at B=%d: rows identical to the plain run "
        "%.4f, the winners' least margin %.4f (tol %.4f); exported back, "
        "the same bits" % (len(sd), n, REF_B, rows_same,
                           float(margin.min()), tol))

    def timed():
        """The converted checkpoint's decode once more, timed (on a
        quiet card) -> captions/s."""
        with calls.paused():
            _sync(torch)
            t0 = time.perf_counter()
            fn(prm, {}, visual)
            _sync(torch)
        return REF_B / (time.perf_counter() - t0)
    return dict(keys=len(sd), parameters=n, rows_identical=rows_same,
                min_margin=float(margin.min()), tol=tol,
                round_trip_bit_identical=True), timed


# -- phase 22: the JAX default mode's LSTM input hoists on K2 ---------------
HOIST_PHASE_S = 60.0          # phase 22's share of the script's time limit
LSTM_MODE = "SICZ_TPU_PALLAS_LSTM"


@contextlib.contextmanager
def lstm_mode(mode):
    """``SICZ_TPU_PALLAS_LSTM`` set to ``mode`` in the block (None: unset,
    the default ``auto``), restored after."""
    saved = os.environ.get(LSTM_MODE)
    if mode is None:
        os.environ.pop(LSTM_MODE, None)
    else:
        os.environ[LSTM_MODE] = mode
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(LSTM_MODE, None)
        else:
            os.environ[LSTM_MODE] = saved


def hoist_cells(bcfg, acfg, ncfg):
    """Phase 22's K2 shapes with a gate term: (forward entry stem, the
    training entries' suffix or None, E, H, rows, lanes, what).  The stems
    are the names the paths credit (phases 10-11, 14, 16-17, 19-20, and
    22's own XE)."""
    hd, d = bcfg.hidden_dim, bcfg.embed_dim
    return [
        ("butd_td_hoist", None, hd + d, hd, B, 1,
         "BUTD's hoisted attention cell [h2, emb], greedy"),
        ("butd_td_hoist_beam", None, hd + d, hd, B * BEAM, BEAM,
         "BUTD's hoisted attention cell, beam 3, the term read by 3 lanes"),
        ("train_butd_td_hoist", "_butd_td_hoist", hd + d, hd, TRAIN_B, 1,
         "BUTD's hoisted attention cell, XE with sampling and SCST"),
        ("train_butd_td_tf", "_butd_td_tf", hd, hd, TRAIN_B, 1,
         "BUTD's teacher-forced attention cell [h2]"),
        ("train_tf", "_tf", FULL["hidden_dim"], FULL["hidden_dim"], TRAIN_B,
         1, "AoADetection's teacher-forced cell [mean + ctx]"),
        ("train_aoasp_tf", "_aoasp_tf", acfg.hidden_dim, acfg.hidden_dim,
         TRAIN_B, 1, "AoASpatial's teacher-forced cell [mean + ctx]"),
        ("train_nic_tf", "_nic_tf", 0, ncfg.hidden_dim, TRAIN_B, 1,
         "NIC's teacher-forced cell, E = 0")]


def hold_hoisted_k2(torch, dev, gen, flush, kernels, on_path, cells):
    """(a) K2 with the gate term at each of ``cells``, in each dtype: the
    forward on the dtype's tensor-core route and on the CUDA-core route
    (forced) within engine/holds' K2 hold (float32 against float64, rtol
    and atol 1e-5; bf16 against the plain version, 1e-2); the backward
    kernel on both routes, d_gates, dc and d_term within the same; the
    whole backward (three launches) within holds.k2_bwd_full_errors, d_term
    (its lanes summed) included; four new term slices, forward and
    backward kernel, encode no TMA map.  Then the forward timed in turns (new,
    library, library, new), host-inclusive and device-only, beside its
    plain version and its bound; the library is torch.addmm of x @ w_x
    into the term's rows, h @ w_hh, then torch._thnn_fused_lstm_cell
    (k2_library).  At the training rows each of the backward's three
    kernels is held and timed too (cli_k2_bwd_entries).  Fills the
    entries the paths credited."""
    from simpleimagecaptionzoo_tpu_torch.engine import holds
    from simpleimagecaptionzoo_tpu_torch.ops import fused_lstm
    out = {}
    src = "simpleimagecaptionzoo_tpu_torch/csrc/fused_lstm.cu"
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
        rate = dn if route == "wgmma" else route
        item = torch.tensor([], dtype=dtype).element_size()
        for stem, sfx, e, hd, rows, lanes, what in cells:
            bw = 1 / hd ** 0.5
            u = lambda *s: ((torch.rand(s, generator=gen, device=dev) * 2  # noqa
                             - 1) * bw).to(dtype)
            w = fused_lstm.prepare_lstm(
                {"w_ih": u(e, 4 * hd), "w_hh": u(hd, 4 * hd),
                 "b_ih": u(4 * hd), "b_hh": u(4 * hd)}, keep=((0, e),))
            x, h, c, dh, dc = (torch.randn(rows, n, generator=gen,
                                           device=dev).to(dtype)
                               for n in (e, hd, hd, hd, hd))
            term = (0.5 * torch.randn(rows // lanes, 4 * hd, generator=gen,
                                      device=dev)).to(dtype)
            kw = dict(term=term, lanes=lanes)
            a5 = (w.w_cat, w.b_sum, x, h, c)
            a7 = a5 + (dh, dc)
            tag = "phase 22 K2 %s %s B=%d E=%d H=%d lanes %d" % (
                dn, what, rows, e, hd, lanes)
            got_route = fused_lstm.lstm_route(w.w_cat, x, h)
            prod_route = fused_lstm.lstm_bwd_products_route(
                w.w_cat, x, h, c, w.b_sum, term, dh, dc)
            require(got_route == route and prod_route == route,
                    "%s: takes the %s route, its backward's products the %s"
                    % (tag, got_route, prod_route))
            errs = {}
            for r in (route, "cuda_core"):
                before = counts(fused_lstm)
                got = (fused_lstm.lstm_cell_fused(*a5, w.split, **kw)
                       if r == route
                       else fused_lstm._run_kernel(*a5, "cuda_core", **kw))
                torch.cuda.synchronize()
                require(moved(counts(fused_lstm), before) == launched(r),
                        "%s %s: the counters moved by %s" % (
                            tag, r, moved(counts(fused_lstm), before)))
                why = holds._hold_k2(holds._lstm_plain, a5, kw, got)
                require(why is None, "%s %s forward: %s" % (tag, r, why))
                ref = fused_lstm.lstm_cell_plain(
                    *(t.double() if dtype == torch.float32 else t
                      for t in a5), term.double()
                    if dtype == torch.float32 else term, lanes)
                errs[r] = max(float((g.double() - v.double()).abs().max())
                              for g, v in zip(got, ref))
                bwd = fused_lstm._run_bwd_kernel(*a7, r, w.split, **kw)
                torch.cuda.synchronize()
                why = holds._hold_k2_bwd(holds._lstm_bwd_plain, a7, kw, bwd)
                require(why is None, "%s %s backward kernel: %s"
                        % (tag, r, why))
            full = fused_lstm.lstm_cell_bwd_full(*a7, w.split, **kw)
            torch.cuda.synchronize()
            ferr = holds.k2_bwd_full_errors(a7, full, term, lanes)
            require(not max(ferr.values()) and full[5].shape == term.shape,
                    "%s: the whole backward beyond its holds by %s" % (
                        tag, ferr))
            # the term takes no tensor map: a step's new slice (teacher
            # forcing's) encodes none, forward or backward kernel, once
            # x's, h's and w_cat's maps are cached
            slices = (0.5 * torch.randn(4, rows // lanes, 4 * hd,
                                        generator=gen, device=dev)).to(dtype)
            enc0 = fused_lstm.map_encodes()
            for t in slices.unbind(0):
                fused_lstm.lstm_cell_fused(*a5, w.split, term=t, lanes=lanes)
                fused_lstm._run_bwd_kernel(*a7, route, w.split, term=t,
                                           lanes=lanes)
            torch.cuda.synchronize()
            term_encodes = fused_lstm.map_encodes() - enc0
            require(term_encodes == 0, "%s: %d TMA maps encoded over 4 new "
                    "term slices" % (tag, term_encodes))
            lib = k2_library(torch, *a5, term, lanes)
            fns = {"new": lambda: fused_lstm.lstm_cell_fused(
                       *a5, w.split, **kw), "lib": lib}
            order = ["new", "lib", "lib", "new"]
            turns = time_turns(torch, fns, flush, order, reps=20)
            dev_turns = time_turns(torch, fns, flush, order, reps=20,
                                   lead=DEVICE_LEAD)
            plain_ms = time_ms(torch, lambda: fused_lstm.lstm_cell_plain(
                *a5, term, lanes), flush)
            nbytes, nops = k2_fwd_size(rows, e, hd, item, lanes)
            b_ms, b_by = bound(nbytes, nops, rate)
            ename = "fused_lstm_cell_%s_%s/%s" % (route, stem, dn)
            stub_entry(kernels, ename).update(
                source=src,
                replaces="simpleimagecaptionzoo_tpu/ops/pallas_lstm.py:166",
                max_abs_err=errs[route], max_err=errs[route],
                cuda_core_max_abs_err=errs["cuda_core"],
                ms=mean(turns["new"]), kernel_ms=mean(turns["new"]),
                device_ms=mean(dev_turns["new"]), plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by,
                library_ms=mean(turns["lib"]),
                device_library_ms=mean(dev_turns["lib"]),
                library_is="torch.addmm of x @ w_x into the term's rows, "
                           "h @ w_hh, torch._thnn_fused_lstm_cell",
                kernel_route=route, turns=turns, device_turns=dev_turns,
                whole_backward_errors=ferr,
                shape="B=%d E=%d H=%d with a gate term, lanes %d (%s)"
                % (rows, e, hd, lanes, what))
            kernels[ename].setdefault("launches", 0)
            log("%s: held on %s and cuda_core (max|err| %.3g, %.3g), the "
                "backward kernel on both, the whole backward (%s); in turns "
                "(new, lib, lib, new): %s %s ms, the library %s ms; device "
                "alone: %s, the library %s ms; plain %.4f ms; bound %.4f ms "
                "(%s)" % (tag, route, errs[route], errs["cuda_core"],
                          ", ".join("%s %.3g" % kv for kv in ferr.items()),
                          route, ["%.4f" % v for v in turns["new"]],
                          ["%.4f" % v for v in turns["lib"]],
                          ["%.4f" % v for v in dev_turns["new"]],
                          ["%.4f" % v for v in dev_turns["lib"]], plain_ms,
                          b_ms, b_by))
            out["%s/%s" % (stem, dn)] = dict(
                max_abs_err=errs, whole_backward=ferr, bound_ms=b_ms,
                ms=mean(turns["new"]), device_ms=mean(dev_turns["new"]),
                library_ms=mean(turns["lib"]), plain_ms=plain_ms)
            if sfx is not None:
                names = {"fused_lstm_cell_bwd": "fused_lstm_cell_bwd_%s%s/%s",
                         "lstm_bwd_dxh": "lstm_bwd_dxh_%s%s/%s",
                         "lstm_bwd_dw": "lstm_bwd_dw_%s%s/%s"}
                cli_k2_bwd_entries(
                    torch, fused_lstm.lstm_cell_bwd_full,
                    a7 + (w.split,), kw,
                    ("K2bwd", route, rows, e, dn, hd, lanes), 0, kernels,
                    on_path, flush, "phase 22", where="hoist",
                    phase="phase 22",
                    name_of=lambda k: names[k] % (route, sfx, dn))
    return out


# a device kernel's kind by its name: the port's own (K1, K2) or a library
# product (cuBLAS, whose Hopper kernels include nvjet_*, and CUTLASS)
LIBRARY_PRODUCT = re.compile(r"gemm|gemv|xmma|cutlass|nvjet", re.I)
# a whole run's device trace of a decode now and then lacks a kernel record
# (37 and 39 K2 records of 40 launched in two of four whole runs; none in
# 90 traces of the decode alone, scripts/probe_trace_records.py): (b)'s
# trace is taken again, up to TRACE_TRIES times in all, until it holds as
# many K2 records as the timed run launched, and every trace's count is
# kept; the gate reads the last trace taken
TRACE_TRIES = 3


def device_kinds(torch, run):
    """One ``run()`` with the device traced (torch.profiler, CUDA alone):
    kind -> [device ms, launches] for "K2" (the fused LSTM cell), "K1"
    (the fused head), "library products" (LIBRARY_PRODUCT) and "other"."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out = {}
    cuda_t = torch.autograd.DeviceType.CUDA
    for ev, n, s, e in raw_events(torch, prof.profiler.kineto_results):
        if ev.device_type() != cuda_t:
            continue
        kind = ("K2" if "lstm_cell" in n else "K1" if "head_" in n
                else "library products" if LIBRARY_PRODUCT.search(n)
                else "other")
        got = out.setdefault(kind, [0.0, 0])
        got[0] += (e - s) / 1e3
        got[1] += 1
    require(out, "the trace holds no device time")
    return out


def hoist_decodes(torch, dev, gen, smi, butd, bparams, bcfg, kernels,
                  on_path):
    """(b) BUTDDetection at full width, B=384, greedy and beam 3, float32
    and bf16, the default mode (``auto``: the attention cell hoisted)
    against ``interpret`` (its whole concat every step), each timed run
    after a warm one: every K2 launch on the dtype's tensor-core route,
    the attention cell's at E = 2,048 (E+H = 3,072) with the term in auto
    and at 4,096 in interpret, the language cell's at 3,072, once a step
    each; the TMA map encodes of auto's decode at most interpret's; in
    float32 99 % of rows identical (the float32 gate of phases 8-9: the
    modes sum the gates in another order, and a near tie of the random
    weights can flip a row) and beam 3's winners rescored within the beam
    gate's tol, in bf16 beam 3 within the beam gate (holds.beam_gate on
    holds.rescored_margin, auto's winners against interpret's) and
    greedy's every kernel call held against its plain version (auto rounds
    the term to bf16, interpret does not: its first ids are reported);
    then each decode
    with the device traced: its ms and launches by kind (K2, K1, library
    products, the rest; device_kinds; traced again, up to TRACE_TRIES
    traces, until a trace holds every K2 record the timed run launched).  No library product computes the
    attention cell a step: auto's decode launches at most 2 library
    products more than interpret's (encode's projection of the mean rows,
    split-K's second kernel) while both run the same steps (float32), and
    K2 twice a step.
    Each timed run's launches are credited to its cells' entries (auto's
    attention cell: ``..._butd_td_hoist``)."""
    from simpleimagecaptionzoo_tpu_torch.engine import holds, steps
    from simpleimagecaptionzoo_tpu_torch.ops import fused_lstm
    visual = {"bu_feats": torch.relu(torch.randn(
        B, N_BOX, bcfg.enc_dim, generator=gen, device=dev)),
        "bu_masks": torch.ones(B, N_BOX, device=dev)}
    e_hoist = bcfg.hidden_dim + bcfg.embed_dim
    e_full = e_hoist + bcfg.enc_dim
    e_lang = bcfg.enc_dim + bcfg.hidden_dim
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
        for kind in ("greedy", "beam"):
            k = BEAM if kind == "beam" else 1
            rows = B * k
            fn = (steps.make_beam_decode(butd, beam_size=BEAM,
                                         max_steps=MAX_LEN, dtype=dtype,
                                         device="cuda")
                  if kind == "beam" else
                  steps.make_greedy_decode(butd, max_len=MAX_LEN,
                                           dtype=dtype, device="cuda"))
            res, ids = {}, {}
            for mode in ("auto", "interpret"):
                tag = "phase 22 BUTDDetection %s %s %s" % (kind, dn, mode)
                with lstm_mode(mode):
                    fn(bparams, {}, visual)                    # warm
                    torch.cuda.synchronize()
                    shapes, t0 = [], time.perf_counter()
                    fused_lstm.COUNT.n = fused_lstm.COUNT_WGMMA.n = 0
                    fused_lstm.COUNT_TF32X3.n = 0
                    enc0 = fused_lstm.map_encodes()
                    with holds.recording_shapes(shapes):
                        got = fn(bparams, {}, visual)
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3
                    encodes = fused_lstm.map_encodes() - enc0
                    n_k2 = (fused_lstm.COUNT.n, fused_lstm.COUNT_WGMMA.n,
                            fused_lstm.COUNT_TF32X3.n)
                    traced = []
                    for _ in range(TRACE_TRIES):
                        kinds = device_kinds(torch, lambda: fn(bparams, {},
                                                               visual))
                        traced.append(kinds.get("K2", [0, 0])[1])
                        if traced[-1] == n_k2[0]:
                            break
                ids[mode] = got[0] if isinstance(got, tuple) else got
                k2 = {}
                for shp in shapes:
                    if shp[0] == "K2":
                        k2[shp] = k2.get(shp, 0) + 1
                n_steps = sum(1 for shp in shapes if shp[0] == "K1")
                e_td = e_hoist if mode == "auto" else e_full
                want = {("K2", route, rows, e_td): n_steps,
                        ("K2", route, rows, e_lang): n_steps}
                require(n_steps >= 1 and k2 == want
                        and n_k2 == launched(route, 2 * n_steps),
                        "%s: K2 launches %s (counters %s), expected %s"
                        % (tag, k2, n_k2, want))
                require(kinds.get("K2", [0, 0])[1] == 2 * n_steps,
                        "%s: the trace holds %s K2 launches for %d steps "
                        "(K2 records in each trace taken: %s)"
                        % (tag, kinds.get("K2"), n_steps, traced))
                res[mode] = dict(steps=n_steps, wall_ms=wall,
                                 k2_records_by_trace=traced,
                                 map_encodes=encodes, launches=n_k2,
                                 device_by_kind=kinds,
                                 device_ms=sum(v[0] for v in kinds.values()))
                log("%s (%s): %d steps, %.2f ms wall, K2 %s, TMA map "
                    "encodes %d; device ms (launches) by kind: %s; all %.3f"
                    % (tag, smi, n_steps, wall, n_k2, encodes,
                       ", ".join("%s %.3f (%d)" % (k, v[0], v[1])
                                 for k, v in sorted(kinds.items())),
                       res[mode]["device_ms"]))
                bsfx = "_beam" if kind == "beam" else ""
                credit_launches(
                    kernels, on_path, tag, n_steps,
                    "fused_lstm_cell_%s_butd_%s%s/%s" % (
                        route, "td_hoist" if mode == "auto" else "td",
                        bsfx, dn),
                    "fused_lstm_cell_%s_butd_lang%s/%s" % (route, bsfx, dn))
            require(res["auto"]["map_encodes"]
                    <= res["interpret"]["map_encodes"],
                    "phase 22 BUTD %s %s: %d TMA map encodes in auto, %d in "
                    "interpret" % (kind, dn, res["auto"]["map_encodes"],
                                   res["interpret"]["map_encodes"]))
            a, b_ = ids["auto"], ids["interpret"]
            same = float((a == b_).all(dim=1).float().mean())
            res["rows_identical"] = same
            if dtype == torch.float32:
                # the two modes sum the attention cell's gates in another
                # order (the mean rows' product apart, then K2's epilogue),
                # so a near tie of the random weights can flip a row: the
                # float32 gate of phases 8-9 (99 % of rows identical), and
                # in beam search every row's winner rescored by the plain
                # step within the beam gate's tol of interpret's
                rows_ok = same >= holds.ROWS_IDENTICAL
                if kind == "beam":
                    margin = holds.rescored_margin(butd, bparams, visual, a,
                                                   b_, dtype, dev)
                    res["rescored_min_margin"] = float(margin.min())
                    rows_ok = rows_ok and float(margin.min()) >= \
                        -holds.beam_tol(dtype, MAX_LEN)
                require(rows_ok, "phase 22 BUTD %s float32: %.4f of auto's "
                        "rows identical to interpret's (gate %.2f)%s"
                        % (kind, same, holds.ROWS_IDENTICAL,
                           "; rescored margin %.4f (tol %.4f)" % (
                               res["rescored_min_margin"],
                               holds.beam_tol(dtype, MAX_LEN))
                           if kind == "beam" else ""))
                extra = (res["auto"]["device_by_kind"].get(
                    "library products", [0, 0])[1]
                    - res["interpret"]["device_by_kind"].get(
                        "library products", [0, 0])[1])
                res["library_products_over_interpret"] = extra
                # a product a step would add one for each of the steps
                require(extra <= 2, "phase 22 BUTD %s float32: auto "
                        "launches %d library products more than interpret "
                        "over the same %d steps" % (
                            kind, extra, res["auto"]["steps"]))
            elif kind == "beam":
                margin = holds.rescored_margin(butd, bparams, visual, a, b_,
                                               dtype, dev)
                tol = holds.beam_tol(dtype, MAX_LEN)
                passed, _ = holds.beam_gate(False, a, b_, margin, tol)
                res["rescored_min_margin"] = float(margin.min())
                require(passed, "phase 22 BUTD beam bf16: auto's winner "
                        "scores %.4f below interpret's (tol %.4f)"
                        % (-float(margin.min()), tol))
            else:
                # auto rounds the hoisted term to bf16 (the params' dtype,
                # as the JAX package's hoisted cell does), interpret sums
                # the mean rows in K2's float32 accumulator: another
                # function in bf16, so greedy's ids are reported, not held
                # to interpret's; each kernel call of auto's decode is held
                res["first_ids_identical"] = float(
                    (a[:, 0] == b_[:, 0]).float().mean())
                broken = []
                with holds.held_calls(broken):
                    fn(bparams, {}, visual)
                torch.cuda.synchronize()
                require(not broken, "phase 22 BUTD greedy bf16: %d kernel "
                        "calls broke their hold (first: %s)"
                        % (len(broken), broken[:1]))
            log("phase 22 BUTDDetection %s %s: rows identical to interpret's "
                "%.4f%s%s; device ms %.3f (auto) against %.3f (interpret)"
                % (kind, dn, same,
                   "; rescored margin %.4f" % res["rescored_min_margin"]
                   if "rescored_min_margin" in res else "",
                   "; first ids %.4f" % res["first_ids_identical"]
                   if "first_ids_identical" in res else "",
                   res["auto"]["device_ms"], res["interpret"]["device_ms"]))
            out["%s/%s" % (kind, dn)] = res
    return out


@contextlib.contextmanager
def xe_ranges(torch, model):
    """The XE step's parts wrapped in profiler ranges (XE_RANGES), as
    drive_xe wraps them."""
    from torch.profiler import record_function
    from simpleimagecaptionzoo_tpu_torch.engine import steps
    from simpleimagecaptionzoo_tpu_torch.ops import decode

    def ranged(name, fn):
        def run(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return run

    saved = (model.encode, decode.teacher_forced_logits,
             steps.label_smoothing_loss, steps.apply_updates_partitioned)
    model.encode = ranged("xe:encode", saved[0])
    decode.teacher_forced_logits = ranged("xe:teacher_forcing", saved[1])
    steps.label_smoothing_loss = ranged("xe:loss", saved[2])
    steps.apply_updates_partitioned = ranged("xe:optimizer", saved[3])
    try:
        yield
    finally:
        del model.encode
        (decode.teacher_forced_logits, steps.label_smoothing_loss,
         steps.apply_updates_partitioned) = saved[1:]


def hoist_xe(torch, args, dev, gen, smi, families, kernels, on_path):
    """(c) XE at full width, B=128 (21 teacher-forced steps), scheduled
    sampling off, dropout at each family's published rates, for
    ``families`` ((name, model, params, cells: mode -> (entry suffix, E)
    of each cell a step runs, init: the E of the cell NIC runs once more,
    its entries' suffix "_nic")), float32 and
    bf16, auto against interpret, one generator seed for both: the first
    step's loss and every gradient through the kernels; in float32 each
    mode held against the same step in float64 (beyond_float64, 1e-4 of
    each leaf's norm beyond the plain float32 run's own distance, the
    references on that mode's ReLU branches for BUTD, relu_branches; the
    losses within 1e-5 of the plain run's and of each other), in bf16 each mode against its own plain run by phase
    14's bf16 hold (each leaf's gradient norm within 2e-2, the loss within
    1e-2), auto against interpret reported; every
    dropout mask drawn identical in the two modes; K2's
    launches by shape exact (auto: the hoisted cells, with their terms);
    then one XE training step (make_xe_train_step, Adam) in each mode
    profiled by part (profile_step).  The
    first steps' launches are
    credited to their cells' entries (auto's hoisted cells: ``..._tf``,
    ``..._butd_td_tf``, ``..._aoasp_tf``, ``..._nic_tf``)."""
    import numpy as np
    from simpleimagecaptionzoo_tpu_torch.engine import holds, optim, steps
    from simpleimagecaptionzoo_tpu_torch.engine.state import TrainState
    from simpleimagecaptionzoo_tpu_torch.models import layers
    from simpleimagecaptionzoo_tpu_torch.ops import fused_lstm
    rng = np.random.default_rng(args.seed + 22)
    n_steps = TRAIN_T - 1
    init_sfx = "_nic"
    out = {}
    for name, model, params, cells, init in families:
        cfg = model.config
        caps = rng.integers(4, cfg.vocab_size, size=(TRAIN_B, TRAIN_T))
        caps[:, 0] = 1
        lens = rng.integers(8, TRAIN_T, size=(TRAIN_B,))
        for i, n in enumerate(lens):
            caps[i, n - 1] = 2
            caps[i, n:] = 0
        visual = ({"features": torch.relu(torch.randn(
            TRAIN_B, cfg.enc_dim, generator=gen, device=dev))}
            if name == "NIC" else
            {"spatial_feats": torch.relu(torch.randn(
                TRAIN_B, cfg.num_pixels, cfg.enc_dim, generator=gen,
                device=dev))}
            if name == "AoASpatial" else
            {"bu_feats": torch.relu(torch.randn(
                TRAIN_B, N_BOX, cfg.enc_dim, generator=gen, device=dev)),
             "bu_masks": torch.ones(TRAIN_B, N_BOX, device=dev)})
        batch = {"visual": visual,
                 "captions": torch.from_numpy(caps).to(dev),
                 "lengths": torch.from_numpy(lens).to(dev)}
        labels = model.param_labels(params)
        leaf_names = optim.tree_leaves(_paths(params))

        def first_step(dtype, masks=None, shapes=None):
            draw = layers.dropout_mask

            def recording(*a, **kw):
                m = draw(*a, **kw)
                if m is not None and masks is not None:
                    masks.append(m)
                return m

            leaves = [p.detach().requires_grad_()
                      for p in optim.tree_leaves(params)]
            layers.dropout_mask = recording
            try:
                with (holds.recording_shapes(shapes) if shapes is not None
                      else contextlib.nullcontext()):
                    loss, _, _ = steps.xe_loss(
                        model, optim.tree_unflatten(params, leaves), {},
                        batch, torch.Generator(device=dev).manual_seed(
                            args.seed + 23), 0.0, smoothing=0.1,
                        compute_dtype=dtype, ss_active=False)
                    grads = torch.autograd.grad(loss, leaves,
                                                allow_unused=True)
            finally:
                layers.dropout_mask = draw
            return float(loss.detach()), [
                torch.zeros_like(p) if g is None else g
                for p, g in zip(leaves, grads)]

        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
            f32 = dtype == torch.float32
            cdtype = None if f32 else dtype
            tag = "phase 22 XE %s %s" % (name, dn)
            t_x = time.time()
            run, branches = {}, {}
            # float32 BUTD: the references replay each kernel run's ReLU
            # branches (relu_branches; its concat attention's ReLU sends
            # pre-activations within rounding of 0 either way, which moves
            # the attention's small leaves by their whole cotangent)
            replay = f32 and name.startswith("BUTD")
            for mode in ("auto", "interpret"):
                masks, shapes = [], []
                branches[mode] = []
                with lstm_mode(mode), relu_branches(torch, branches[mode],
                                                    on=replay):
                    loss, grads = first_step(cdtype, masks, shapes)
                got = {}
                for shp in shapes:
                    got[shp] = got.get(shp, 0) + 1
                want = {}
                for _, e in cells[mode]:
                    for kn in ("K2", "K2bwd", "K2dxh", "K2dw"):
                        want[(kn, route, TRAIN_B, e)] = n_steps
                if init is not None:
                    for kn in ("K2", "K2bwd", "K2dxh", "K2dw"):
                        key = (kn, route, TRAIN_B, init)
                        want[key] = want.get(key, 0) + 1
                require(got == want, "%s %s: K2 launches by shape %s, "
                        "expected %s" % (tag, mode, got, want))
                run[mode] = (loss, grads, masks)
                runs = [(sfx, n_steps) for sfx, _ in cells[mode]]
                if init is not None:
                    runs.append((init_sfx, 1))
                for sfx, n in runs:
                    credit_launches(
                        kernels, on_path, tag, n,
                        "fused_lstm_cell_%s_train%s/%s" % (route, sfx, dn),
                        "fused_lstm_cell_bwd_%s%s/%s" % (route, sfx, dn),
                        "lstm_bwd_dxh_%s%s/%s" % (route, sfx, dn),
                        "lstm_bwd_dw_%s%s/%s" % (route, sfx, dn))
            (la, ga, ma), (li, gi, mi) = run["auto"], run["interpret"]
            require(len(ma) == len(mi) > 0 and all(
                bool(torch.equal(x, y)) for x, y in zip(ma, mi)),
                "%s: the dropout masks differ between auto and interpret "
                "(%d and %d masks)" % (tag, len(ma), len(mi)))
            res = dict(loss=dict(auto=la, interpret=li), masks=len(ma))
            if f32:
                # each mode against the same step in float64 through the
                # plain versions (the same function in both modes up to
                # rounding), on that mode's ReLU branches where replayed
                for mode, (lk, gk, _) in run.items():
                    flips = []
                    with lstm_mode(mode), holds.plain_versions():
                        with relu_branches(torch, branches[mode], flips,
                                           on=replay):
                            lp, gp = first_step(None)
                        with relu_branches(torch, branches[mode], flips,
                                           on=replay):
                            ge = first_step(torch.float64)[1]
                    if replay:
                        res["relu_flips_" + mode] = check_flips(
                            flips, "%s %s" % (tag, mode))
                    ex = beyond_float64(gk, gp, ge)
                    res.update({"plain_loss_" + mode: lp,
                                "excess_" + mode: ex[0],
                                "kernels_" + mode: ex[1],
                                "plain_" + mode: ex[2]})
                    require(ex[0] <= 1e-4 and abs(lk - lp) <= 1e-5 * lp,
                            "%s %s: the loss %.6f against the plain run's "
                            "%.6f (tol 1e-5); gradients beyond float64 by "
                            "%.3g of a leaf's norm past the plain run's (tol "
                            "1e-4; worst %s)" % (
                                tag, mode, lk, lp, ex[0],
                                [(x, leaf_names[j])
                                 for x, _, _, j in ex[3]][:2]))
                    del gp, ge
                require(abs(la - li) <= 1e-5 * li, "%s: the losses %.6f "
                        "(auto) and %.6f (interpret) differ beyond 1e-5"
                        % (tag, la, li))
            else:
                # phase 14's bf16 hold, each mode against its own plain
                # run: each leaf's gradient norm within 2e-2 (floored at
                # 1e-3 of the largest leaf's), the loss within 1e-2; auto
                # against interpret is reported (auto rounds the hoisted
                # term to bf16, the params' dtype, as the JAX package's
                # hoisted cell does: another function in bf16)
                def norm_gap(ks, ps):
                    pn = [float(g.float().norm()) for g in ps]
                    floor = 1e-3 * max(pn)
                    return [abs(float(k.float().norm()) - p) / max(p, floor)
                            for k, p in zip(ks, pn)]

                for mode, (lk, gk, _) in run.items():
                    with lstm_mode(mode), holds.plain_versions():
                        lp, gp = first_step(cdtype)
                    rel = norm_gap(gk, gp)
                    res["grad_norm_vs_plain_%s" % mode] = max(rel)
                    require(max(rel) <= 2e-2 and abs(lk - lp) <= 1e-2 * lp,
                            "%s %s: against its plain run the losses %.6f "
                            "and %.6f (tol 1e-2), a leaf's gradient norm off "
                            "by %.3g (tol 2e-2; %s)" % (
                                tag, mode, lk, lp, max(rel),
                                leaf_names[int(np.argmax(rel))]))
                    del gp
                res["grad_norm_max_rel_diff"] = max(norm_gap(ga, gi))
            del ga, gi
            res["seconds"] = dict(first_steps=time.time() - t_x)
            # one training step in each mode, profiled by part
            tx = optim.make_grad_transform("Adam", 0.1)
            step = steps.make_xe_train_step(
                model, tx, labels, smoothing=0.1, compute_dtype=cdtype,
                ss_active=False, device="cuda")
            st = TrainState.create(params, tx, {})
            res["profile"] = {}
            for mode in ("auto", "interpret"):
                with lstm_mode(mode), xe_ranges(torch, model):
                    g = torch.Generator(device=dev).manual_seed(args.seed)
                    step(st, batch, g, 0.0, TRAIN_LR, 0.0)     # warm
                    p = profile_step(torch, lambda: step(
                        st, batch, g, 0.0, TRAIN_LR, 0.0),
                        "%s %s (%s)" % (tag, mode, smi))
                require_no_products(p, "%s %s" % (tag, mode))
                res["profile"][mode] = p
            res["seconds"]["profiled"] = (time.time() - t_x
                                          - res["seconds"]["first_steps"])
            log("%s: auto and interpret draw the same %d masks; losses "
                "%.6f and %.6f%s; device ms a step (busy) %.3f (auto) "
                "against %.3f (interpret), K2 forward %.3f / %.3f, K2 "
                "backward kernel %.3f / %.3f, its products %.3f / %.3f (%s)"
                % (tag, len(ma), la, li,
                   "; beyond float64 %.3g and %.3g" % (
                       res["excess_auto"], res["excess_interpret"])
                   if f32 else "; gradient norms within %.3g of each other"
                   % res["grad_norm_max_rel_diff"],
                   *(res["profile"][m]["device_busy_ms"]
                     for m in ("auto", "interpret")),
                   *(res["profile"][m]["parts_ms"].get(part, 0.0)
                     for part in ("K2 forward kernel", "K2 backward kernel",
                                  "K2 backward's product kernels")
                     for m in ("auto", "interpret")), smi))
            out["%s/%s" % (name, dn)] = res
    return out


def drive_hoists(torch, args, dev, gen, smi, flush, kernels, on_path, *,
                 butd, bparams, aoa, aparams, nic, nparams, aoasp, spparams):
    """Phase 22: the JAX default mode's LSTM input hoists on K2 with its
    gate term, within HOIST_PHASE_S: (a) :func:`hold_hoisted_k2` at
    :func:`hoist_cells`' shapes; (b) :func:`hoist_decodes`, BUTDDetection
    greedy and beam 3; (c) :func:`hoist_xe`, the XE of BUTDDetection,
    AoADetection, AoASpatial (``aoasp``, its params ``spparams``) and NIC;
    (d) the device's ms by part of (b) and (c), auto against interpret,
    with the card's name and power limit."""
    t22 = time.time()
    bcfg, ncfg, scfg = butd.config, nic.config, aoasp.config
    out = {"card": smi}
    out["k2"] = hold_hoisted_k2(torch, dev, gen, flush, kernels, on_path,
                                hoist_cells(bcfg, scfg, ncfg))
    t_a = time.time()
    out["decode"] = hoist_decodes(torch, dev, gen, smi, butd, bparams, bcfg,
                                  kernels, on_path)
    t_b = time.time()
    hd, d, e = bcfg.hidden_dim, bcfg.embed_dim, bcfg.enc_dim
    families = [
        ("BUTDDetection", butd, bparams,
         {"auto": [("_butd_td_tf", hd), ("_butd_lang", e + hd)],
          "interpret": [("_butd_td", hd + e + d), ("_butd_lang", e + hd)]},
         None),
        ("AoADetection", aoa, aparams,
         {"auto": [("_tf", FULL["hidden_dim"])],
          "interpret": [("", FULL["embed_dim"] + FULL["hidden_dim"])]},
         None),
        ("AoASpatial", aoasp, spparams,
         {"auto": [("_aoasp_tf", scfg.hidden_dim)],
          "interpret": [("_aoasp", scfg.embed_dim + scfg.hidden_dim)]},
         None),
        ("NIC", nic, nparams,
         {"auto": [("_nic_tf", 0)], "interpret": [("_nic", ncfg.embed_dim)]},
         ncfg.embed_dim)]
    out["xe"] = hoist_xe(torch, args, dev, gen, smi, families, kernels,
                         on_path)
    out["seconds"] = dict(total=time.time() - t22, k2=t_a - t22,
                          decode=t_b - t_a, xe=time.time() - t_b)
    log("phase 22 took %.1f s (K2 %.1f, decode %.1f, XE %.1f; XE by run %s)"
        % (out["seconds"]["total"], out["seconds"]["k2"],
           out["seconds"]["decode"], out["seconds"]["xe"], json.dumps({
               k: {p: round(x, 2) for p, x in v["seconds"].items()}
               for k, v in out["xe"].items()})))
    require(out["seconds"]["total"] <= HOIST_PHASE_S, "phase 22 took %.1f s, "
            "over its %.0f s" % (out["seconds"]["total"], HOIST_PHASE_S))
    return out


# -- phase 23: the COCO14 dry run through the port; the mesh's model axis --
PHASE23_S = 90.0              # phase 23's share of the script's time limit
DRY_MODELS = (("AoADetection", "dry_aoadet"), ("NIC", "dry_nic"))
MP = 2                        # (b): the model axis's processes
MP_XE_B = 128                 # (b): the XE step's batch
MP_TOL = 1e-5                 # (b): the XE loss (relative), the head (abs.)


def drive_dry_runs(torch, dev, gpu, root):
    """(a) ``tools/reproduce_coco14.dry_run`` of each of DRY_MODELS under
    ``root``, in this process, every kernel launch recorded (KernelCalls):
    the fixture, the port's five preprocessing entry points, its CLI's XE,
    SCST and eval, and every file the shell script's dry run asserts (the
    tool raises on a missing one, on an SCST best record that the SCST
    history's val CIDEr does not call for or that it lacks, or on a CLI's
    exit code other than 0).
    -> ({model: readings}, {model: its KernelCalls})."""
    from simpleimagecaptionzoo_tpu_torch.tools import reproduce_coco14
    out, recs = {}, {}
    for model, _ in DRY_MODELS:
        calls = KernelCalls()
        t0 = time.time()
        with calls.recording(torch):
            reproduce_coco14.dry_run(model, gpu,
                                     os.path.join(root, "dry_" + model))
        _sync(torch)
        launches = {kind: sum(n for key, n in calls.count.items()
                              if key[0] == kind)
                    for kind in ("K1", "K2", "K2bwd")}
        require(dev.type != "cuda" or all(launches.values()),
                "phase 23 (a) %s: kernel launches %s; the dry run must "
                "launch K1, K2 and K2's backward" % (model, launches))
        out[model] = dict(seconds=time.time() - t0, launches=launches,
                          shapes=len(calls.count))
        recs[model] = calls
        log("phase 23 (a) %s: DRY RUN OK in %.1f s, launches %s (%d shapes)"
            % (model, out[model]["seconds"], launches, len(calls.count)))
    return out, recs


def mp_inputs(torch, seed, dev, dims):
    """(b)'s model, params (the whole head), decode batch (``b`` rows,
    ``n_box`` boxes of which 10-36 valid at 36) and XE batch (``xe_b``
    rows, captions of 3-``t`` tokens), the same on every process."""
    import numpy as np
    from simpleimagecaptionzoo_tpu_torch.config import ModelConfig
    from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
    gen = torch.Generator(device=dev).manual_seed(seed + 23)
    rng = np.random.default_rng(seed + 23)
    model = get_captioner(ModelConfig(**dims["aoa"]))
    params = model.init_params(gen)
    cfg = model.config
    b, nb, xb, t = dims["b"], dims["n_box"], dims["xe_b"], dims["t"]
    lo = max(1, nb * 10 // 36)
    n_valid = lo + torch.arange(b, device=dev) % (nb - lo + 1)
    visual = {"bu_feats": torch.relu(torch.randn(b, nb, cfg.enc_dim,
                                                 generator=gen, device=dev)),
              "bu_masks": (torch.arange(nb, device=dev)[None, :]
                           < n_valid[:, None]).float()}
    caps = rng.integers(4, cfg.vocab_size, size=(xb, t))
    caps[:, 0] = 1
    lens = rng.integers(3, t + 1, size=(xb,))
    for i, n in enumerate(lens):
        caps[i, n - 1] = 2
        caps[i, n:] = 0
    xe = {"visual": {"bu_feats": torch.relu(torch.randn(
        xb, nb, cfg.enc_dim, generator=gen, device=dev)),
        "bu_masks": torch.ones(xb, nb, device=dev)},
        "captions": torch.from_numpy(caps).to(dev),
        "lengths": torch.from_numpy(lens).to(dev)}
    return model, params, visual, xe


def mp_runs(torch, model, params, visual, xe, dev, seed):
    """Greedy (MAX_LEN) and beam-3 decodes in float32 and bf16, and one
    XE step (Adam, dropout at the published rates from a generator seeded
    from ``seed``, sampling off) of ``params`` -> readings: the ids, the
    fused head's calls a decode, the steps greedy took, the XE loss and the
    updated ``predict``."""
    from simpleimagecaptionzoo_tpu_torch.engine import optim, steps
    from simpleimagecaptionzoo_tpu_torch.engine.state import TrainState
    from simpleimagecaptionzoo_tpu_torch.ops import fused_head
    topk, calls = fused_head.topk_head, []

    def counted(head, x, k):
        calls.append(tuple(head.w.shape))
        return topk(head, x, k)
    out = {}
    fused_head.topk_head = counted
    try:
        for dn, dtype in (("float32", None), ("bfloat16", torch.bfloat16)):
            for kind, make in (
                    ("greedy", lambda: steps.make_greedy_decode(
                        model, max_len=MAX_LEN, dtype=dtype, device=dev)),
                    ("beam", lambda: steps.make_beam_decode(
                        model, beam_size=BEAM, max_steps=MAX_LEN,
                        dtype=dtype, device=dev))):
                n = len(calls)
                ids = make()(params, {}, visual)
                _sync(torch)
                out["%s/%s" % (kind, dn)] = dict(
                    ids=ids, k1_calls=len(calls) - n,
                    head_shapes=sorted(set(calls[n:])),
                    steps=_steps_taken(ids) if kind == "greedy" else None)
    finally:
        fused_head.topk_head = topk
    tx = optim.make_grad_transform("Adam", 0.1)
    step = steps.make_xe_train_step(model, tx, model.param_labels(params),
                                    0.1, ss_active=False, device=dev)
    st, met = step(TrainState.create(params, tx), xe,
                   torch.Generator(device=dev).manual_seed(seed + 7), 0.0,
                   TRAIN_LR, 0.0)
    out["xe"] = dict(loss=float(met["loss"]), predict=st.params["predict"])
    return out


def mp_child(argv):
    """``chip_smoke.py --phase23-mp CASE RANK WORLD STORE OUT``: one
    process of (b) on the card (cuda:0).  Before the group starts it runs
    :func:`mp_runs` on the whole head alone (the one-process reference;
    process 0 only); once the parent has written CASE's ``go`` file it
    joins the gloo group (a FileStore at STORE), lays the (data, model)
    mesh with a model axis of WORLD, keeps its vocab shard of the head
    (``place_params``) and runs :func:`mp_runs` again, every kernel launch
    recorded; then each K1 call of a float32 greedy and a bf16 beam decode
    held against its plain version, each process's K1 on its shard timed
    in turn (device-only), a float32 greedy decode profiled (the merge's
    span) and timed by both processes at once (captions/s).  Process 0
    gathers the updated head's shards, gates the runs against the
    reference (:func:`mp_compare`), makes the K1 entries of the kernels
    line (``where`` shard) and writes the readings to OUT (json)."""
    case_path, rank, world, store, out_path = argv
    rank, world = int(rank), int(world)
    with open(case_path) as f:
        case = json.load(f)
    import torch
    from torch.profiler import ProfilerActivity, profile
    from simpleimagecaptionzoo_tpu_torch import parallel
    from simpleimagecaptionzoo_tpu_torch.device import resolve_device
    from simpleimagecaptionzoo_tpu_torch.engine import holds, steps
    from simpleimagecaptionzoo_tpu_torch.ops import fused_head
    from simpleimagecaptionzoo_tpu_torch.parallel import vocab_shard
    dev = resolve_device(case["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    model, params, visual, xe = mp_inputs(torch, case["seed"], dev,
                                          case["dims"])
    ref = mp_runs(torch, model, params, visual, xe, dev,
                  case["seed"]) if rank == 0 else None
    t0 = time.time()
    while not os.path.exists(case["go"]):
        require(time.time() - t0 < CHILD_S, "phase 23 (b): no word")
        time.sleep(0.05)
    parallel.configure_collective_timeout(90)
    parallel.init_process_group("gloo", world, rank,
                                store=torch.distributed.FileStore(store,
                                                                  world))
    mesh = parallel.get_mesh(dev, model_parallel=world)
    shard = parallel.place_params(mesh, params)
    calls = KernelCalls()
    with calls.recording(torch):
        got = mp_runs(torch, model, shard, visual, xe, dev, case["seed"])
    res = {"rank": rank, "mesh": [mesh.size, mesh.index, mesh.model_size,
                                  mesh.model_index],
           "launches": {str(k): n for k, n in calls.count.items()}}
    # on the card every fused-head call of the decodes launched K1 once
    k1_calls = sum(v["k1_calls"] for k, v in got.items() if k != "xe")
    k1_launches = sum(n for key, n in calls.count.items() if key[0] == "K1")
    require(dev.type != "cuda" or k1_launches == k1_calls,
            "phase 23 (b) process %d: K1 launched %d times for %d calls"
            % (rank, k1_launches, k1_calls))
    # every K1 call of a float32 greedy and a bf16 beam decode held
    broken = []
    with holds.held_calls(broken):
        steps.make_greedy_decode(model, max_len=MAX_LEN, device=dev)(
            shard, {}, visual)
        steps.make_beam_decode(model, beam_size=BEAM, max_steps=MAX_LEN,
                               dtype=torch.bfloat16, device=dev)(
            shard, {}, visual)
    res["held_broken"] = len(broken)
    require(not broken, "phase 23 (b) process %d: %d kernel calls broke "
            "their hold (first: %s)" % (rank, len(broken), broken[:1]))
    # each process's K1 on its shard, device-only, one process at a time
    head = {dn: fused_head.prepare_head(shard["predict"], dt)
            for dn, dt in (("float32", torch.float32),
                           ("bfloat16", torch.bfloat16))}
    hd = model.config.hidden_dim
    res["k1_shard_device_ms"] = {}
    for turn in range(world):
        parallel.barrier("phase23_k1_%d" % turn)
        if turn != rank or dev.type != "cuda":
            continue
        flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32,
                            device=dev)
        for dn, h in head.items():
            for m, k in ((case["dims"]["b"], 1),
                         (case["dims"]["b"] * BEAM, BEAM)):
                x = torch.randn(m, hd, device=dev).to(h.w.dtype
                                                       if dn == "bfloat16"
                                                       else torch.float32)
                res["k1_shard_device_ms"]["%s/m%dk%d" % (dn, m, k)] = \
                    time_ms(torch, lambda: fused_head.topk_head(h, x, k),
                            flush, lead=DEVICE_LEAD)
    # the merge's span a greedy step, and both processes' captions/s
    greedy = steps.make_greedy_decode(model, max_len=MAX_LEN, device=dev)
    acts = [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        ids = greedy(shard, {}, visual)
        _sync(torch)
    n_steps = _steps_taken(ids)
    cpu_t = torch.autograd.DeviceType.CPU
    res["merge_ms_per_step"] = sum(
        e - s for ev, name, s, e in raw_events(
            torch, prof.profiler.kineto_results)
        if name == "vocab_shard.topk_merge"
        and ev.device_type() == cpu_t) / 1e3 / max(n_steps, 1)
    parallel.barrier("phase23_timed")
    t0 = time.perf_counter()
    greedy(shard, {}, visual)
    _sync(torch)
    res["captions_per_s"] = case["dims"]["b"] / (time.perf_counter() - t0)
    res["ids_agree"] = parallel.processes_agree(
        got["greedy/float32"]["ids"].cpu().numpy())
    # the updated head, its shards side by side (process 0 keeps it)
    upd = {k: vocab_shard.gather_logits(v.detach())
           for k, v in got["xe"]["predict"].items()}
    torch.distributed.destroy_process_group()
    parallel.get_mesh(dev)
    if rank == 0:
        t0 = time.perf_counter()
        greedy(params, {}, visual)
        _sync(torch)
        res["one_process_captions_per_s"] = (case["dims"]["b"]
                                             / (time.perf_counter() - t0))
        res["measured"] = mp_compare(torch, model, params, visual, dev, got,
                                     ref, upd, world)
        if dev.type == "cuda":
            kernels, on_path = {}, set()
            flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32,
                                device=dev)
            cli_kernel_entries(torch, calls, kernels, on_path, flush,
                               "phase 23 shard", where="shard",
                               phase="phase 23", kinds=("K1",))
            res["kernels"] = kernels
    with open(out_path, "w") as f:
        json.dump(res, f, default=float)
    return 0


def mp_compare(torch, model, params, visual, dev, got, ref, upd, world):
    """(b)'s gates, the model axis's run ``got`` against the one-process
    run ``ref`` of the same inputs: float32 greedy ids identical; float32
    beam by phases 8-9's float32 gate (holds.beam_gate: ROWS_IDENTICAL of
    the rows); bf16 beam by the beam gate (the winners rescored by the
    plain step on the whole head within holds.beam_tol); K1 called once a
    greedy step taken (as the reference) and as often as the reference in
    beam search, every call on the shard's padded width; the XE loss within
    MP_TOL of the reference's (relative) and the updated head (``upd``: the
    shards side by side) within MP_TOL of the reference's update."""
    from simpleimagecaptionzoo_tpu_torch.engine import holds
    from simpleimagecaptionzoo_tpu_torch.ops import fused_head
    v = model.config.vocab_size
    vp = -(-(v // world) // fused_head.V_TILE) * fused_head.V_TILE
    kp = -(-model.config.hidden_dim // fused_head.K_ALIGN) * \
        fused_head.K_ALIGN
    meas = {}
    for dn, dtype in (("float32", torch.float32),
                      ("bfloat16", torch.bfloat16)):
        for kind in ("greedy", "beam"):
            g, r = got["%s/%s" % (kind, dn)], ref["%s/%s" % (kind, dn)]
            tag = "phase 23 (b) %s %s" % (kind, dn)
            same = float((g["ids"] == r["ids"]).all(dim=1).float().mean())
            require(g["head_shapes"] == [(kp, vp)]
                    and g["k1_calls"] == r["k1_calls"]
                    and (kind == "beam" or g["k1_calls"] == g["steps"]),
                    "%s: K1 called %d times on %s, the reference %d times "
                    "(greedy steps %s); the shard is (%d, %d)"
                    % (tag, g["k1_calls"], g["head_shapes"], r["k1_calls"],
                       g["steps"], kp, vp))
            m = dict(rows_identical=same, k1_calls=g["k1_calls"])
            if kind == "greedy" and dtype == torch.float32:
                require(same == 1.0, "%s: %.4f of rows identical to one "
                        "process's" % (tag, same))
            elif kind == "beam":
                margin = holds.rescored_margin(model, params, visual,
                                               g["ids"], r["ids"], dtype,
                                               dev)
                tol = holds.beam_tol(dtype, MAX_LEN)
                passed, _ = holds.beam_gate(dtype == torch.float32,
                                            g["ids"], r["ids"], margin, tol)
                m.update(min_margin=float(margin.min()), tol=tol)
                require(passed, "%s: %.4f of rows identical to one "
                        "process's, rescored margin %.4f (tol %.4f)"
                        % (tag, same, float(margin.min()), tol))
            meas["%s/%s" % (kind, dn)] = m
    gl, rl = got["xe"]["loss"], ref["xe"]["loss"]
    gaps = {k: float((upd[k].float() - ref["xe"]["predict"][k].float())
                     .abs().max()) for k in ref["xe"]["predict"]}
    require(abs(gl - rl) <= MP_TOL * abs(rl) and max(gaps.values())
            <= MP_TOL, "phase 23 (b) XE: loss %.7g against one process's "
            "%.7g (tol %g relative), the updated head off by %s (tol %g)"
            % (gl, rl, MP_TOL, gaps, MP_TOL))
    meas["xe"] = dict(loss=gl, ref_loss=rl, head_gap=gaps)
    return meas


def drive_phase23(torch, args, dev, smi, flush, kernels, on_path,
                  dims=None, gpu="0"):
    """Phase 23, within PHASE23_S: (a) the COCO14 dry run through the port
    (:func:`drive_dry_runs`) of AoADetection (bottom-up features) and NIC
    (pixels, the ResNet-101) at the width of their Configs/Models json on
    the card, an entry of the kernels line for every launch shape
    (``where`` dry_aoadet, dry_nic), each held against its plain version
    on the path's own inputs; (b) the mesh's model axis: MP processes under
    gloo sharing the card (:func:`mp_child`), started first, their runs
    on the model axis waiting until (a) is done.  ``dims`` (the model and
    batches of (b)) and ``gpu`` (the dry run's --gpu_id) default to the
    card's run at full width; a rehearsal on the CPU passes its own."""
    import tempfile
    t_phase = time.time()
    root = tempfile.mkdtemp(prefix="chip_smoke_p23_")
    out = {"card": smi}
    try:
        go = os.path.join(root, "go")
        dims = dims or dict(aoa=FULL, b=B, n_box=N_BOX, xe_b=MP_XE_B,
                            t=TRAIN_T)
        case = os.path.join(root, "mp.json")
        with open(case, "w") as f:
            json.dump({"seed": args.seed, "dims": dims, "go": go,
                       "device": "cuda:0" if dev.type == "cuda"
                       else "cpu"}, f)
        procs = []
        for r in range(MP):
            log_path = os.path.join(root, "mp%d.log" % r)
            res_path = os.path.join(root, "mp%d.json" % r)
            procs.append((r, res_path, log_path, _child(
                ["--phase23-mp", case, str(r), str(MP),
                 os.path.join(root, "mp.store"), res_path], log_path)))
        t_a = time.time()
        out["a"], recs = drive_dry_runs(torch, dev, gpu, root)
        out["a"]["seconds"] = time.time() - t_a
        with open(go, "w"):
            pass
        t_b = time.time()
        out["b"] = {}
        for r, res_path, log_path, proc in procs:
            _wait(proc, log_path, "(b) process %d" % r, CHILD_S,
                  phase="phase 23")
            with open(res_path) as f:
                got = json.load(f)
            for ename, entry in got.pop("kernels", {}).items():
                kernels[ename] = entry
                on_path.add(ename)
            out["b"][r] = got
        out["b"]["seconds"] = time.time() - t_b
        m = out["b"][0]
        log("phase 23 (b) model axis of %d under gloo on one card (%s): %s; "
            "K1 on each process's shard, device ms %s; the merge %.3f / "
            "%.3f ms a greedy step; captions/s %.1f / %.1f (two processes) "
            "against %.1f (one)" % (
                MP, smi, json.dumps(m["measured"]),
                json.dumps([out["b"][r]["k1_shard_device_ms"]
                            for r in range(MP)]),
                *(out["b"][r]["merge_ms_per_step"] for r in range(MP)),
                *(out["b"][r]["captions_per_s"] for r in range(MP)),
                m["one_process_captions_per_s"]))
        if dev.type == "cuda":
            for model, where in DRY_MODELS:
                cli_kernel_entries(torch, recs[model], kernels, on_path,
                                   flush, "phase 23 " + where, where=where,
                                   phase="phase 23")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.time() - t_phase
    log("phase 23 took %.1f s (a %.1f, b %.1f)" % (
        out["seconds"], out["a"]["seconds"], out["b"]["seconds"]))
    require(out["seconds"] <= PHASE23_S, "phase 23 took %.1f s, over its "
            "%.0f s" % (out["seconds"], PHASE23_S))
    return out


# -- phase 24: the synthetic-data quality gate and the two demos ----------
PHASE24_S = 240.0             # phase 24's share of the script's time limit
# QUALITY_r04_AoADetection_zipf.json's settings, every other flag at its
# default: the JAX package's AoADetection record that carries every part of
# the gate.  QUALITY_r03_AoADetection.json's settings (uniform words, beam
# tolerance 0.01) put the beam part inside the reference's own noise: its
# record has no beam part, the JAX script at those settings on the CPU reads
# beam 0.16 below greedy and SCST below XE, the port 0.016 below on the
# card (PERF.md)
GATE_ARGV = ["--model", "AoADetection", "--zipf", "--beam_tolerance", "0.05",
             "--n_images", "2000", "--epochs", "5", "--scst_epochs", "4",
             "--gate"]
# demo_e2e at the verify skill's recipe (40 steps reads WEAK); demo_scst
# runs at its defaults
DEMO_E2E_ARGV = ["--model", "AoADetection", "--steps", "60"]


@contextlib.contextmanager
def captured(path):
    """The block's stdout and stderr (the CLI's tables, any progress bars)
    into the file ``path``; its last lines are logged if the block
    raises."""
    with open(path, "w") as f:
        try:
            with contextlib.redirect_stdout(f), contextlib.redirect_stderr(f):
                yield
        except BaseException:
            f.flush()
            with open(path) as g:
                tail = g.read()[-6000:]
            log("the captured output's last lines (%s):\n%s" % (path, tail))
            raise


def drive_phase24(torch, args, dev, smi, flush, kernels, on_path):
    """Phase 24, within PHASE24_S: (a) the port's quality gate
    (``examples/train_synthetic.run``) in this process at GATE_ARGV, every
    kernel launch recorded (KernelCalls), its record read in all three
    parts, an entry of the kernels line for every launch shape (``where``
    gate_aoadet) held against its plain version on the path's own inputs;
    (b) the two demos: ``demo_e2e`` (DEMO_E2E_ARGV) must read OK;
    ``demo_scst`` at its defaults must keep its greedy policy's CIDEr-D
    (at least 0.8 of it) with finite rewards, and its result (OK or WEAK:
    the rewards' trend over its 60 steps, which carries the rollout's
    dropout noise) is printed as read."""
    import tempfile
    from simpleimagecaptionzoo_tpu_torch.examples import (demo_e2e,
                                                          demo_scst,
                                                          train_synthetic)
    t_phase = time.time()
    root = tempfile.mkdtemp(prefix="chip_smoke_p24_")
    out = {"card": smi}
    try:
        # -- (a) the gate ----------------------------------------------------
        calls = KernelCalls()
        gargs = train_synthetic.build_argparser().parse_args(
            GATE_ARGV + ["--root", os.path.join(root, "synth")])
        with captured(os.path.join(root, "gate.log")), \
                calls.recording(torch):
            res = train_synthetic.run(gargs)
        _sync(torch)
        launches = {kind: sum(n for key, n in calls.count.items()
                              if key[0] == kind)
                    for kind in ("K1", "K2", "K2bwd")}
        rec = res["record"]
        out["a"] = dict(record=rec, seconds=res["seconds"],
                        xe_steps_per_sec=res["xe_steps_per_sec"],
                        scst_steps_per_sec=res["scst_steps_per_sec"],
                        launches=launches, shapes=len(calls.count),
                        gate_seconds=time.time() - t_phase)
        log("phase 24 (a) QUALITY_GATE: %s" % json.dumps(rec))
        log("phase 24 (a) on %s: stage seconds %s; XE steps/s by epoch %s, "
            "SCST steps/s by epoch %s (the first step of each excluded); "
            "launches %s (%d shapes)" % (
                smi, json.dumps({k: round(v, 2)
                                 for k, v in res["seconds"].items()}),
                json.dumps([round(r, 2) for r in res["xe_steps_per_sec"]]),
                json.dumps([round(r, 2)
                            for r in res["scst_steps_per_sec"]]),
                launches, len(calls.count)))
        scst, xe = rec["scst_val_cider"], rec["xe_val_cider"]
        parts = dict(
            xe=xe >= rec["xe_threshold"],
            scst=scst is not None and scst > xe,
            beam=(rec["beam_ge_greedy"] and rec["beam3_val_cider"]
                  >= rec["greedy_val_cider"] - rec["beam_tolerance"]))
        require(rec["gate"] == "PASS" and res["rc"] == 0 and all(
            parts.values()), "phase 24 (a): the gate reads %s (parts %s)"
            % (rec["gate"], parts))
        require(all(launches.values()), "phase 24 (a): kernel launches %s; "
                "the gate must launch K1, K2 and K2's backward" % launches)
        cli_kernel_entries(torch, calls, kernels, on_path, flush,
                           "phase 24 gate_aoadet", where="gate_aoadet",
                           phase="phase 24")
        del calls
        # -- (b) the demos ---------------------------------------------------
        t_b = time.time()
        with captured(os.path.join(root, "demo_e2e.log")):
            e2e = demo_e2e.run(demo_e2e.build_argparser().parse_args(
                DEMO_E2E_ARGV))
        with captured(os.path.join(root, "demo_scst.log")):
            sc = demo_scst.run(demo_scst.build_argparser().parse_args([]))
        _sync(torch)
        out["b"] = dict(demo_e2e=e2e, demo_scst=sc,
                        seconds=time.time() - t_b)
        log("phase 24 (b) demo_e2e %s: DEMO_RESULT: %s (loss %.4f -> %.4f, "
            "greedy exact %d / %d, CIDEr-D greedy %.2f beam %.2f)" % (
                " ".join(DEMO_E2E_ARGV), "OK" if e2e["ok"] else "WEAK",
                e2e["first_loss"], e2e["final_loss"], e2e["n_correct"],
                e2e["n_img"], e2e["cider_greedy"], e2e["cider_beam"]))
        r = sc["rewards"]
        log("phase 24 (b) demo_scst: DEMO_RESULT: %s (greedy CIDEr-D %.3f -> "
            "%.3f; mean reward of the first 10 steps %.4f, of the last 10 "
            "%.4f)" % ("OK" if sc["ok"] else "WEAK", sc["cider_before"],
                       sc["cider_after"], sum(r[:10]) / 10,
                       sum(r[-10:]) / 10))
        require(e2e["ok"], "phase 24 (b): demo_e2e reads WEAK")
        require(all(math.isfinite(x) for x in r)
                and sc["cider_after"] >= 0.8 * sc["cider_before"],
                "phase 24 (b): demo_scst's greedy CIDEr-D %.3f -> %.3f, "
                "rewards finite: %s" % (sc["cider_before"], sc["cider_after"],
                                        all(math.isfinite(x) for x in r)))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.time() - t_phase
    log("phase 24 took %.1f s (a %.1f, its entries %.1f, b %.1f) on %s" % (
        out["seconds"], out["a"]["gate_seconds"],
        out["seconds"] - out["a"]["gate_seconds"] - out["b"]["seconds"],
        out["b"]["seconds"], smi))
    require(out["seconds"] <= PHASE24_S, "phase 24 took %.1f s, over its "
            "%.0f s" % (out["seconds"], PHASE24_S))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the results as JSON to this file")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 1
    from simpleimagecaptionzoo_tpu_torch.config import (ModelConfig,
                                                        load_model_config)
    from simpleimagecaptionzoo_tpu_torch.device import resolve_device
    from simpleimagecaptionzoo_tpu_torch.engine import holds, steps
    from simpleimagecaptionzoo_tpu_torch.models.base import get_captioner
    from simpleimagecaptionzoo_tpu_torch.ops import (_build, fused_head,
                                                     fused_lstm,
                                                     int8_attention, quant,
                                                     tf32)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)

    dev = resolve_device("cuda")
    name = torch.cuda.get_device_name(0)
    results = {"card": smi, "torch": torch.__version__,
               "cuda": torch.version.cuda, "seed": args.seed}

    # -- 2. build -------------------------------------------------------------
    t0 = t_start = time.time()
    libs = ["fused_head", "fused_lstm", "lstm_bwd", "quant_matmul",
            "int8_attention"]
    lib_paths = _build.build(libs)
    results["build_s"] = time.time() - t0
    log("build: %s from csrc in %.2f s" % (", ".join(libs),
                                           results["build_s"]))
    results["sass"], results["ptxas"] = {}, {}
    for lname in ("fused_lstm", "fused_head", "quant_matmul"):
        text = sass_text(_build, lname, lib_paths[lname])
        ops = sass_counts(text)
        require(all(v > 0 for v in ops.values()),
                "%s: the SASS holds %s; the tensor-core routes need HGMMA "
                "(tf32 in K1, K2 and K3) and UTMALDG" % (lname, ops))
        results["sass"][lname] = ops
        results["ptxas"][lname] = ptxas_lines(lib_paths[lname])
        log("SASS %s: %s" % (lname, ", ".join("%s x %d" % kv
                                              for kv in ops.items())))
        # the 2xTF32 kernels on their own: tf32 wgmma fed by TMA
        for fname, body in sass_functions(text).items():
            if "tf32x2" not in fname:
                continue
            fops = sass_counts(body)
            require(fops["UTMALDG"] > 0 and fops[SASS_OPS[2]] > 0,
                    "%s: the SASS of %s holds %s; the tf32x2 route needs "
                    "the tf32 HGMMA and UTMALDG" % (lname, fname, fops))
            results["sass"]["%s:%s" % (lname, fname)] = fops
            log("SASS %s: %s" % (fname, ", ".join("%s x %d" % kv
                                                  for kv in fops.items())))
        for line in results["ptxas"][lname]:
            log("  ptxas " + line)
    require(sum("tf32x2" in n for n in results["sass"]) == 2,
            "the SASS lacks a tf32x2 kernel: %s" % list(results["sass"]))
    # K2 backward's products: each of the four kernels on its own, bf16 or
    # tf32 HGMMA fed by UTMALDG
    text = sass_text(_build, "lstm_bwd", lib_paths["lstm_bwd"])
    results["ptxas"]["lstm_bwd"] = ptxas_lines(lib_paths["lstm_bwd"],
                                               markers=("lstm_bwd",))
    found = []
    for fname, body in sass_functions(text).items():
        if "lstm_bwd" not in fname:
            continue
        fops = sass_counts(body)
        tf32_kernel = "tf32x3" in fname
        ok = fops["UTMALDG"] > 0 and (
            fops[SASS_OPS[2]] > 0 if tf32_kernel
            else fops["HGMMA"] > 0 and fops[SASS_OPS[2]] == 0)
        require(ok, "lstm_bwd: the SASS of %s holds %s; it needs %s HGMMA "
                "and UTMALDG" % (fname, fops, "the tf32" if tf32_kernel
                                 else "the bf16"))
        results["sass"]["lstm_bwd:%s" % fname] = fops
        found.append(fname)
        log("SASS %s: %s" % (fname, ", ".join("%s x %d" % kv
                                              for kv in fops.items())))
    require(sorted(("tf32x3" in f, "dxh" in f) for f in found)
            == [(False, False), (False, True), (True, False), (True, True)],
            "lstm_bwd: the SASS holds the kernels %s, not dx·dh and dW·db "
            "on both routes" % found)
    for line in results["ptxas"]["lstm_bwd"]:
        log("  ptxas " + line)
    # K4's "tma" route loads K and V with TMA (no tensor-core product)
    ops = sass_counts(sass_text(_build, "int8_attention",
                                lib_paths["int8_attention"]),
                      ops=("UTMALDG",))
    require(ops["UTMALDG"] > 0, "int8_attention: the SASS holds %s; the tma "
            "route needs UTMALDG" % ops)
    results["sass"]["int8_attention"] = ops
    results["ptxas"]["int8_attention"] = ptxas_lines(
        lib_paths["int8_attention"], markers=("attend_tma",))
    log("SASS int8_attention: UTMALDG x %d" % ops["UTMALDG"])
    for line in results["ptxas"]["int8_attention"]:
        log("  ptxas " + line)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = get_captioner(ModelConfig(**FULL))
    params = model.init_params(gen)
    # BUTDDetection and BUTDSpatial at the width of their published configs
    # (one param tree serves both: feature mode has no CNN)
    butd, butd_sp = (get_captioner(load_model_config(
        os.path.join(HERE, "Configs", "Models", fam + ".json"),
        vocab_size=FULL["vocab_size"])) for fam in ("BUTDDetection",
                                                    "BUTDSpatial"))
    bparams = butd.init_params(gen)
    bcfg = butd.config
    # the widths of x at each BUTD launch: K2's E (the attention cell's
    # [h2, mean, emb], the language cell's [attended, h1]); K3's K (each
    # cell's [x, h], att_dec's h1)
    e_td = bcfg.hidden_dim + bcfg.enc_dim + bcfg.embed_dim
    e_lang = bcfg.enc_dim + bcfg.hidden_dim
    butd_k2 = (("td", "lstm_td", e_td), ("lang", "lstm_lang", e_lang))
    # the paths' cells in the default mode: the attention cell hoisted
    # (x = [h2, emb], td_mean_gates its gate term; phase 22 holds and times
    # it, entries ..._butd_td_hoist)
    e_td_hoist = bcfg.hidden_dim + bcfg.embed_dim
    butd_k2_path = (("td_hoist", "lstm_td", e_td_hoist),
                    ("lang", "lstm_lang", e_lang))
    butd_k3 = (("td", "lstm_td", e_td + bcfg.hidden_dim),
               ("lang", "lstm_lang", e_lang + bcfg.hidden_dim),
               ("att_dec", "att_dec", bcfg.hidden_dim))
    # NIC and AoASpatial at the width of their published configs (512)
    nic, aoasp = (get_captioner(load_model_config(
        os.path.join(HERE, "Configs", "Models", fam + ".json"),
        vocab_size=FULL["vocab_size"])) for fam in ("NIC", "AoASpatial"))
    nparams, aparams = nic.init_params(gen), aoasp.init_params(gen)
    ncfg, acfg = nic.config, aoasp.config
    e_nic = ncfg.embed_dim                       # the cell's x: an embedding
    e_aoasp = acfg.embed_dim + acfg.hidden_dim   # [emb, ctx]
    # K2 at the other families' cells: (entry tag, cell params, E, what)
    more_k2 = [("butd_" + tag, bparams[cell], e, "BUTD's %s cell" % tag)
               for tag, cell, e in butd_k2] + [
        ("nic", nparams["lstm"], e_nic, "NIC's cell"),
        ("aoasp", aparams["lstm"], e_aoasp, "AoASpatial's cell")]
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=dev)
    kernels = {}

    def entry(kname, dtype_name, **kw):
        kernels["%s/%s" % (kname, dtype_name)] = dict(
            name="%s/%s" % (kname, dtype_name), route="cuda", **kw)

    mb = 3 * B                                      # beam rows: B x 3 beams

    def head_at(fam, head, hd, dtype, tc_route, rate, ename):
        """K1 (a float head) or K1-int8 (an int8 head) at another family's
        head: held on the tensor-core route (k=1, k=3 and three rows at
        m=B; k=3 at m=mb), then timed in turns (new, lib, lib, new),
        host-inclusive and device-only, beside cuBLAS's bare x @ W (the
        int8 W dequantized to x's type) at m=B, k=1 and m=mb, k=3; entries
        <ename>_<fam> and <ename>_<fam>_beam."""
        dn = str(dtype).split(".")[1]
        int8 = head.w.dtype == torch.int8
        tf32 = "tf32x2" if int8 else "tf32x3"
        tol = 1e-4 if dtype == torch.float32 else 2e-3
        x = (0.5 * torch.randn(B, hd, generator=gen, device=dev)).to(dtype)
        xb = (0.5 * torch.randn(mb, hd, generator=gen, device=dev)).to(dtype)
        route = fused_head.head_route(head.w, x)
        require(route == tc_route, "K1 %s %s takes the %s route"
                % (fam, dn, route))
        tag = "K1%s/%s %s" % ("-int8" if int8 else "", route, fam)
        before = counts(fused_head, tf32)
        err = hold_head(torch, fused_head, tag, head, x, dn, tol,
                        extra=[(xb, 3)])
        delta = moved(counts(fused_head, tf32), before)
        require(delta == launched(tc_route, 4, tf32=tf32),
                "%s %s: the counters moved by %s" % (tag, dn, delta))
        w_x = (head.w[:hd].float() * head.s).to(dtype)
        item, w_item = x.element_size(), head.w.element_size()
        for m, k, xs in ((B, 1, x), (mb, 3, xb)):
            fns = {"new": lambda: fused_head.topk_head(head, xs, k),
                   "lib": lambda: xs @ w_x}
            order = ["new", "lib", "lib", "new"]
            turns = time_turns(torch, fns, flush, order)
            dev_turns = time_turns(torch, fns, flush, order,
                                   lead=DEVICE_LEAD)
            plain_ms = time_ms(
                torch, lambda: fused_head.topk_head_plain(head, xs, k), flush)
            nbytes = (m * hd * item + hd * head.v * w_item + 2 * head.v * 4
                      + m * (k * 8 + 4))
            nops = 2 * m * hd * head.v
            b_ms, b_by = bound(nbytes, nops, rate)
            scheme = ({"scheme_bound_ms": bound(nbytes, nops, "2xtf32")[0]}
                      if tc_route == "tf32x2" else {})
            entry("%s_%s%s" % (ename, fam, "_beam" if m == mb else ""), dn,
                  max_abs_err=err, max_err=err, ms=mean(turns["new"]),
                  kernel_ms=mean(turns["new"]),
                  device_ms=mean(dev_turns["new"]), plain_ms=plain_ms,
                  bound_ms=b_ms, bound_by=b_by, **scheme, library_ms=None,
                  product_ms=mean(turns["lib"]),
                  device_product_ms=mean(dev_turns["lib"]),
                  kernel_route=tc_route, turns=turns, device_turns=dev_turns,
                  shape="m=%d K=%d V=%d%s k=%d (%s's head)"
                  % (m, hd, head.v, " int8 W" if int8 else "", k, fam),
                  source="simpleimagecaptionzoo_tpu_torch/csrc/fused_head.cu",
                  replaces="simpleimagecaptionzoo_tpu/ops/fused_head.py:155")
            log("%s %s m=%d k=%d in turns (new, lib, lib, new): %s %s ms, x "
                "@ W alone (cuBLAS) %s ms; device alone: %s %s, x @ W %s ms; "
                "plain %.4f ms; bound %.4f ms (%s%s)"
                % (tag, dn, m, k, tc_route,
                   ["%.4f" % t for t in turns["new"]],
                   ["%.4f" % t for t in turns["lib"]], tc_route,
                   ["%.4f" % t for t in dev_turns["new"]],
                   ["%.4f" % t for t in dev_turns["lib"]], plain_ms, b_ms,
                   b_by, "".join("; 2xTF32's %.4f" % v
                                 for v in scheme.values())))

    log("-- phase 3 at %.1f s" % (time.time() - t_start))
    # -- 3. K1 against its plain version --------------------------------------
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        tc_route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
        rate = dn if tc_route == "wgmma" else tc_route     # for bound()
        tol = 1e-4 if dtype == torch.float32 else 2e-3
        head = fused_head.prepare_head(
            steps._cast_floats(params["predict"], dtype), dtype)
        x = (0.5 * torch.randn(B, FULL["hidden_dim"], generator=gen,
                               device=dev)).to(dtype)
        xb = (0.5 * torch.randn(mb, FULL["hidden_dim"], generator=gen,
                                device=dev)).to(dtype)
        route = fused_head.head_route(head.w, x)
        require(route == tc_route, "K1 %s takes the %s route" % (dn, route))
        before = counts(fused_head)
        err = hold_head(torch, fused_head, "K1/" + route, head, x, dn, tol,
                        extra=[(xb, 3)])
        require(moved(counts(fused_head), before)
                == launched(tc_route, 4),
                "K1 %s: the counters moved by %s"
                % (dn, moved(counts(fused_head), before)))
        # the CUDA-core route, which operands TMA cannot take go to
        before = counts(fused_head)
        old_err = hold_head(torch, fused_head, "K1/cuda_core", head, x, dn,
                            tol, route="cuda_core")
        require(moved(counts(fused_head), before) == launched("cuda_core", 3),
                "K1 %s forced onto the cuda_core route: the counters moved "
                "by %s" % (dn, moved(counts(fused_head), before)))
        kp, vp_ = head.w.shape
        hd = FULL["hidden_dim"]
        item = x.element_size()

        def k1_bound(m, k, rate):
            nbytes = (m * hd * item + hd * head.v * item + 2 * head.v * 4
                      + m * (k * 8 + 4))
            return bound(nbytes, 2 * m * hd * head.v, rate)

        b_ms, b_by = k1_bound(B, 1, rate)
        bb_ms, bb_by = k1_bound(mb, 3, rate)
        plain_ms = time_ms(torch,
                           lambda: fused_head.topk_head_plain(head, x, 1),
                           flush)
        beam_plain_ms = time_ms(
            torch, lambda: fused_head.topk_head_plain(head, xb, 3), flush)
        shape = ("m=%d K=%d V=%d (padded %dx%d) k=1" % (B, hd, head.v, kp,
                                                        vp_))
        k1_fns = {
            "old": lambda: fused_head._run_kernel(head, x, 1, "cuda_core"),
            "new": lambda: fused_head.topk_head(head, x, 1)}
        beam_fns = {
            "old": lambda: fused_head._run_kernel(head, xb, 3, "cuda_core"),
            "new": lambda: fused_head.topk_head(head, xb, 3)}
        order = ["old", "new", "new", "old"]
        turns = time_turns(torch, k1_fns, flush, order)
        dev_turns = time_turns(torch, k1_fns, flush, order, lead=DEVICE_LEAD)
        beam = time_turns(torch, beam_fns, flush, order)
        dev_beam = time_turns(torch, beam_fns, flush, order, lead=DEVICE_LEAD)
        prod_ms = time_ms(torch, lambda: x @ head.w, flush)
        prod_beam_ms = time_ms(torch, lambda: xb @ head.w, flush)
        ms = mean(turns["new"])
        common = dict(
            source="simpleimagecaptionzoo_tpu_torch/csrc/fused_head.cu",
            replaces="simpleimagecaptionzoo_tpu/ops/fused_head.py:155",
            plain_ms=plain_ms, library_ms=None, shape=shape,
            beam_shape="m=%d k=3" % mb, product_ms=prod_ms,
            beam_product_ms=prod_beam_ms)
        if tc_route == "tf32x3":
            # the CUDA-core route's own entry, held to float32's CUDA-core
            # rate; no decode runs it now
            ob_ms, ob_by = k1_bound(B, 1, dn)
            entry("fused_head_topk", dn, max_abs_err=old_err,
                  max_err=old_err, ms=mean(turns["old"]),
                  kernel_ms=mean(turns["old"]),
                  device_ms=mean(dev_turns["old"]), bound_ms=ob_ms,
                  bound_by=ob_by, kernel_route="cuda_core",
                  beam_ms=mean(beam["old"]),
                  beam_device_ms=mean(dev_beam["old"]),
                  beam_bound_ms=k1_bound(mb, 3, dn)[0], **common)
        entry("fused_head_topk_" + tc_route, dn, max_abs_err=err,
              max_err=err, ms=ms, kernel_ms=ms, bound_ms=b_ms, bound_by=b_by,
              kernel_route=tc_route, turns=turns,
              old_route_ms=mean(turns["old"]),
              old_route_max_abs_err=old_err,
              device_turns=dev_turns, device_ms=mean(dev_turns["new"]),
              device_old_route_ms=mean(dev_turns["old"]),
              beam_turns=beam, beam_ms=mean(beam["new"]),
              beam_old_route_ms=mean(beam["old"]),
              beam_device_turns=dev_beam,
              beam_device_ms=mean(dev_beam["new"]),
              beam_bound_ms=bb_ms, **common)
        entry("fused_head_topk_%s_beam" % tc_route, dn, max_abs_err=err,
              max_err=err, ms=mean(beam["new"]), kernel_ms=mean(beam["new"]),
              device_ms=mean(dev_beam["new"]), plain_ms=beam_plain_ms,
              bound_ms=bb_ms, bound_by=bb_by, library_ms=None,
              kernel_route=tc_route, shape="m=%d K=%d V=%d k=3" % (mb, hd,
                                                                   head.v),
              source=common["source"], replaces=common["replaces"],
              product_ms=prod_beam_ms)
        log("K1 %s timing in turns (old, new, new, old): %s %s ms, "
            "cuda_core %s ms; plain %.4f ms; x @ W alone (cuBLAS) %.4f ms; "
            "bound %.4f ms (%s)"
            % (dn, tc_route, ["%.4f" % t for t in turns["new"]],
               ["%.4f" % t for t in turns["old"]], plain_ms, prod_ms, b_ms,
               b_by))
        log("K1 %s at m=%d k=3 in turns: %s %s ms, cuda_core %s ms; "
            "x @ W alone %.4f ms; plain %.4f ms; bound %.4f ms (%s)"
            % (dn, mb, tc_route, ["%.4f" % t for t in beam["new"]],
               ["%.4f" % t for t in beam["old"]], prod_beam_ms, beam_plain_ms,
               bb_ms, bb_by))
        log("K1 %s device time alone, in turns: m=%d k=1 %s %s, cuda_core "
            "%s ms; m=%d k=3 %s %s, cuda_core %s ms"
            % (dn, B, tc_route, ["%.4f" % t for t in dev_turns["new"]],
               ["%.4f" % t for t in dev_turns["old"]], mb, tc_route,
               ["%.4f" % t for t in dev_beam["new"]],
               ["%.4f" % t for t in dev_beam["old"]]))
        # the SCST baseline's greedy rows (m=128, k=1), timed in turns
        # beside cuBLAS's bare x @ W (the product alone)
        x128 = (0.5 * torch.randn(TRAIN_B, hd, generator=gen,
                                  device=dev)).to(dtype)
        before = counts(fused_head)
        err128 = hold_head(torch, fused_head, "K1/%s train" % tc_route, head,
                           x128, dn, tol)
        require(moved(counts(fused_head), before) == launched(tc_route, 3),
                "K1 %s m=%d: the counters moved by %s"
                % (dn, TRAIN_B, moved(counts(fused_head), before)))
        fns128 = {"new": lambda: fused_head.topk_head(head, x128, 1),
                  "lib": lambda: x128 @ head.w}
        order128 = ["new", "lib", "lib", "new"]
        t128 = time_turns(torch, fns128, flush, order128)
        d128 = time_turns(torch, fns128, flush, order128, lead=DEVICE_LEAD)
        plain128 = time_ms(
            torch, lambda: fused_head.topk_head_plain(head, x128, 1), flush)
        b128 = k1_bound(TRAIN_B, 1, rate)
        entry("fused_head_topk_%s_train" % tc_route, dn, max_abs_err=err128,
              max_err=err128, ms=mean(t128["new"]),
              kernel_ms=mean(t128["new"]), device_ms=mean(d128["new"]),
              plain_ms=plain128, bound_ms=b128[0], bound_by=b128[1],
              library_ms=None, product_ms=mean(t128["lib"]),
              device_product_ms=mean(d128["lib"]), kernel_route=tc_route,
              turns=t128, device_turns=d128,
              shape="m=%d K=%d V=%d k=1 (SCST's greedy baseline)"
              % (TRAIN_B, hd, head.v), source=common["source"],
              replaces=common["replaces"])
        log("K1 %s m=%d k=1 in turns (new, lib, lib, new): %s %s ms, x @ W "
            "alone (cuBLAS) %s ms; device alone: %s %s, x @ W %s ms; plain "
            "%.4f ms; bound %.4f ms (%s)"
            % (dn, TRAIN_B, tc_route, ["%.4f" % t for t in t128["new"]],
               ["%.4f" % t for t in t128["lib"]], tc_route,
               ["%.4f" % t for t in d128["new"]],
               ["%.4f" % t for t in d128["lib"]], plain128, b128[0],
               b128[1]))
        # the 512-wide families' heads
        for fam, fparams, fcfg in (("nic", nparams, ncfg),
                                   ("aoasp", aparams, acfg)):
            head_at(fam, fused_head.prepare_head(
                steps._cast_floats(fparams["predict"], dtype), dtype),
                fcfg.hidden_dim, dtype, tc_route, rate,
                "fused_head_topk_" + tc_route)

    # the tie across chunks, with chunks made only of pad columns, on each
    # route of each dtype (3.0 and 1.0 are exact in bf16 and TF32)
    v = 2 * fused_head.V_TILE
    w = torch.zeros((8, v), device=dev)
    w[:, 7] = 3.0
    w[:, fused_head.V_TILE + 11] = 3.0
    w[:, 100] = 1.0
    for dtype, route in ((torch.float32, "tf32x3"),
                         (torch.float32, "cuda_core"),
                         (torch.bfloat16, "wgmma"),
                         (torch.bfloat16, "cuda_core")):
        tie_head = fused_head.prepare_head({"w": w[:, :700].to(dtype)}, dtype)
        eye = torch.eye(8, tie_head.w.shape[0], device=dev, dtype=dtype)
        if route == fused_head.head_route(tie_head.w, eye):
            _, ti, tl = fused_head.topk_head(tie_head, eye, 3)
        else:
            _, ti, tl = fused_head._run_kernel(tie_head, eye, 3, route)
        _, pi, pl = fused_head.topk_head_plain(tie_head, eye, 3)
        require(ti.tolist() == [[7, fused_head.V_TILE + 11, 100]] * 8
                and torch.equal(ti, pi) and bool(torch.isfinite(tl).all())
                and float((tl - pl).abs().max()) <= 1e-4,
                "K1 tie case %s: %s" % (route, ti.tolist()))
        log("K1 tie across chunks, %s %s route (%d-column chunks): ids %s, "
            "lse finite" % (str(dtype).split(".")[1], route,
                            fused_head.V_TILE * 2 // fused_head.head_chunks(
                                route, 2 * fused_head.V_TILE),
                            ti[0].tolist()))

    log("-- phase 4 at %.1f s" % (time.time() - t_start))
    # -- 4. K2 against its plain version --------------------------------------
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        tc_route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
        rate = dn if tc_route == "wgmma" else tc_route     # for bound()
        tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
               else dict(rtol=1e-2, atol=1e-2))
        w_cat, b_sum, split = fused_lstm.prepare_lstm(
            steps._cast_floats(params["lstm"], dtype))
        hd = FULL["hidden_dim"]
        e_in = FULL["embed_dim"] + hd
        errs = {tc_route: 0.0, "cuda_core": 0.0}
        wb = 1 / hd ** 0.5
        w200 = ((torch.rand(200 + hd, 4 * hd, generator=gen, device=dev) * 2
                 - 1) * wb).to(dtype)
        split200 = (tf32.prepare_split(w200)
                    if dtype == torch.float32 else None)
        # the other families' cells (phases 10-13), each with its weights:
        # tag -> (cell params, prepared weights, E, H, what)
        more = {}
        for tag, lp, e, what in more_k2:
            lp = steps._cast_floats(lp, dtype)
            more[tag] = (lp, fused_lstm.prepare_lstm(lp), e,
                         lp["w_hh"].shape[0], what)
        # the decode step, the unaligned E=200 and the beam rows on the
        # tensor-core route; the CUDA-core route, which shapes TMA cannot
        # take go to, at the first two; the other families' cells at the
        # greedy and the beam rows on the tensor-core route
        shapes = [(None, B, e_in, hd, w_cat, b_sum, split, tc_route),
                  (None, B, 200, hd, w200, b_sum, split200, tc_route),
                  (None, mb, e_in, hd, w_cat, b_sum, split, tc_route),
                  (None, B, e_in, hd, w_cat, b_sum, split, "cuda_core"),
                  (None, B, 200, hd, w200, b_sum, split200, "cuda_core")] + [
            (tag, m, e, hh, bw.w_cat, bw.b_sum, bw.split, tc_route)
            for tag, (_, bw, e, hh, _) in more.items() for m in (B, mb)]
        case_err = {}          # (tag, B) -> max |err| on the tensor-core route
        for tag, m, e, hh, wc, bs, sp, route in shapes:
            x, h, c = (torch.randn(m, n, generator=gen, device=dev).to(dtype)
                       for n in (e, hh, hh))
            before = counts(fused_lstm)
            if route == tc_route:
                got_route = fused_lstm.lstm_route(wc, x, h)
                require(got_route == route, "K2 %s B=%d E=%d takes the %s "
                        "route" % (dn, m, e, got_route))
                kh, kc = fused_lstm.lstm_cell_fused(wc, bs, x, h, c, sp)
            else:
                kh, kc = fused_lstm._run_kernel(wc, bs, x, h, c, route)
            torch.cuda.synchronize()
            require(moved(counts(fused_lstm), before) == launched(route),
                    "K2 %s %s B=%d E=%d: the counters moved by %s"
                    % (dn, route, m, e, moved(counts(fused_lstm), before)))
            ph, pc = fused_lstm.lstm_cell_plain(wc, bs, x, h, c)
            err = 0.0
            for got, want, what in ((kh, ph, "h'"), (kc, pc, "c'")):
                diff = (got.float() - want.float()).abs()
                lim = tol["atol"] + tol["rtol"] * want.float().abs()
                require(bool((diff <= lim).all()),
                        "K2 %s %s B=%d E=%d %s: max |err| %.3g beyond rtol %g "
                        "atol %g" % (dn, route, m, e, what,
                                     float(diff.max()), tol["rtol"],
                                     tol["atol"]))
                err = max(err, float(diff.max()))
            if tag is None:
                errs[route] = max(errs[route], err)
            else:
                case_err[tag, m] = err
            log("K2 %s (%s) B=%d E=%d H=%d: max|err| %.3g (rtol %g atol %g)"
                % (dn, route, m, e, hh, err, tol["rtol"], tol["atol"]))
        err = errs[tc_route]
        # the library yardstick: torch.lstm_cell on weights transposed once
        lp = steps._cast_floats(params["lstm"], dtype)
        w_ih_t = lp["w_ih"].t().contiguous()
        w_hh_t = lp["w_hh"].t().contiguous()
        item = torch.tensor([], dtype=dtype).element_size()
        timed = {}
        for m in (B, mb):
            x, h, c = (torch.randn(m, n, generator=gen, device=dev).to(dtype)
                       for n in (e_in, hd, hd))
            fns = {"old": lambda: fused_lstm._run_kernel(
                       w_cat, b_sum, x, h, c, "cuda_core"),
                   "new": lambda: fused_lstm.lstm_cell_fused(
                       w_cat, b_sum, x, h, c, split),
                   "lib": lambda: torch.lstm_cell(
                       x, (h, c), w_ih_t, w_hh_t, lp["b_ih"], lp["b_hh"])}
            order = ["old", "new", "lib", "lib", "new", "old"]
            nbytes = ((m * (e_in + 2 * hd) + (e_in + hd) * 4 * hd + 4 * hd
                       + 2 * m * hd) * item)
            nops = 2 * m * (e_in + hd) * 4 * hd
            timed[m] = dict(
                turns=time_turns(torch, fns, flush, order),
                dev_turns=time_turns(torch, fns, flush, order,
                                     lead=DEVICE_LEAD),
                plain_ms=time_ms(torch, lambda: fused_lstm.lstm_cell_plain(
                    w_cat, b_sum, x, h, c), flush),
                bound=bound(nbytes, nops, rate),
                old_bound=bound(nbytes, nops, dn))
        g, bm = timed[B], timed[mb]
        b_ms, b_by = g["bound"]
        common = dict(
            source="simpleimagecaptionzoo_tpu_torch/csrc/fused_lstm.cu",
            replaces="simpleimagecaptionzoo_tpu/ops/pallas_lstm.py:166",
            plain_ms=g["plain_ms"], library_ms=mean(g["turns"]["lib"]),
            device_library_ms=mean(g["dev_turns"]["lib"]),
            shape="B=%d E=%d H=%d" % (B, e_in, hd), beam_shape="B=%d" % mb,
            beam_plain_ms=bm["plain_ms"],
            beam_library_ms=mean(bm["turns"]["lib"]),
            beam_device_library_ms=mean(bm["dev_turns"]["lib"]))
        if tc_route == "tf32x3":
            # the CUDA-core route's own entry, held to float32's CUDA-core
            # rate; no decode runs it now
            entry("fused_lstm_cell", dn, max_abs_err=errs["cuda_core"],
                  max_err=errs["cuda_core"], ms=mean(g["turns"]["old"]),
                  kernel_ms=mean(g["turns"]["old"]),
                  device_ms=mean(g["dev_turns"]["old"]),
                  bound_ms=g["old_bound"][0], bound_by=g["old_bound"][1],
                  kernel_route="cuda_core",
                  beam_device_ms=mean(bm["dev_turns"]["old"]),
                  beam_bound_ms=bm["old_bound"][0], **common)
        ms = mean(g["turns"]["new"])
        entry("fused_lstm_cell_" + tc_route, dn, max_abs_err=err,
              max_err=err, ms=ms, kernel_ms=ms, bound_ms=b_ms, bound_by=b_by,
              kernel_route=tc_route, turns=g["turns"],
              old_route_ms=mean(g["turns"]["old"]),
              old_route_max_abs_err=errs["cuda_core"],
              device_turns=g["dev_turns"],
              device_ms=mean(g["dev_turns"]["new"]),
              device_old_route_ms=mean(g["dev_turns"]["old"]),
              beam_turns=bm["turns"], beam_device_turns=bm["dev_turns"],
              beam_ms=mean(bm["turns"]["new"]),
              beam_device_ms=mean(bm["dev_turns"]["new"]),
              beam_device_old_route_ms=mean(bm["dev_turns"]["old"]),
              beam_bound_ms=bm["bound"][0], **common)
        entry("fused_lstm_cell_%s_beam" % tc_route, dn, max_abs_err=err,
              max_err=err, ms=mean(bm["turns"]["new"]),
              kernel_ms=mean(bm["turns"]["new"]),
              device_ms=mean(bm["dev_turns"]["new"]),
              plain_ms=bm["plain_ms"], bound_ms=bm["bound"][0],
              bound_by=bm["bound"][1], library_ms=mean(bm["turns"]["lib"]),
              device_library_ms=mean(bm["dev_turns"]["lib"]),
              kernel_route=tc_route, shape="B=%d E=%d H=%d" % (mb, e_in, hd),
              source=common["source"], replaces=common["replaces"])
        for m, t in timed.items():
            log("K2 %s B=%d timing in turns (old, new, lib, lib, new, old): "
                "%s %s ms, torch.lstm_cell %s ms, cuda_core %s ms; device "
                "alone: %s %s, torch.lstm_cell %s, cuda_core %s ms; plain "
                "%.4f ms; bound %.4f ms (%s; the CUDA-core rate's %.4f)"
                % (dn, m, tc_route, ["%.4f" % v for v in t["turns"]["new"]],
                   ["%.4f" % v for v in t["turns"]["lib"]],
                   ["%.4f" % v for v in t["turns"]["old"]], tc_route,
                   ["%.4f" % v for v in t["dev_turns"]["new"]],
                   ["%.4f" % v for v in t["dev_turns"]["lib"]],
                   ["%.4f" % v for v in t["dev_turns"]["old"]],
                   t["plain_ms"], t["bound"][0], t["bound"][1],
                   t["old_bound"][0]))

        # the other families' cells, timed in turns beside torch.lstm_cell
        for tag, (lp, bw, e, hh, what) in more.items():
            w_ih_t = lp["w_ih"].t().contiguous()
            w_hh_t = lp["w_hh"].t().contiguous()
            for m in (B, mb):
                x, h, c = (torch.randn(m, n, generator=gen,
                                       device=dev).to(dtype)
                           for n in (e, hh, hh))
                err = case_err[tag, m]
                fns = {"new": lambda: fused_lstm.lstm_cell_fused(
                           bw.w_cat, bw.b_sum, x, h, c, bw.split),
                       "lib": lambda: torch.lstm_cell(
                           x, (h, c), w_ih_t, w_hh_t, lp["b_ih"],
                           lp["b_hh"])}
                order = ["new", "lib", "lib", "new"]
                turns = time_turns(torch, fns, flush, order)
                dev_turns = time_turns(torch, fns, flush, order,
                                       lead=DEVICE_LEAD)
                plain_ms = time_ms(torch, lambda: fused_lstm.lstm_cell_plain(
                    bw.w_cat, bw.b_sum, x, h, c), flush)
                nbytes = ((m * (e + 2 * hh) + (e + hh) * 4 * hh + 4 * hh
                           + 2 * m * hh) * item)
                b_ms, b_by = bound(nbytes, 2 * m * (e + hh) * 4 * hh, rate)
                entry("fused_lstm_cell_%s_%s%s"
                      % (tc_route, tag, "_beam" if m == mb else ""), dn,
                      max_abs_err=err, max_err=err, ms=mean(turns["new"]),
                      kernel_ms=mean(turns["new"]),
                      device_ms=mean(dev_turns["new"]), plain_ms=plain_ms,
                      bound_ms=b_ms, bound_by=b_by,
                      library_ms=mean(turns["lib"]),
                      device_library_ms=mean(dev_turns["lib"]),
                      kernel_route=tc_route, turns=turns,
                      device_turns=dev_turns,
                      shape="B=%d E=%d H=%d (%s)" % (m, e, hh, what),
                      source=common["source"], replaces=common["replaces"])
                log("K2 %s %s B=%d E=%d H=%d: max|err| %.3g (rtol %g atol "
                    "%g); in turns (new, lib, lib, new): %s %s ms, "
                    "torch.lstm_cell %s ms; device alone: %s %s, "
                    "torch.lstm_cell %s ms; plain %.4f ms; bound %.4f ms (%s)"
                    % (dn, what, m, e, hh, err, tol["rtol"], tol["atol"],
                       tc_route,
                       ["%.4f" % v for v in turns["new"]],
                       ["%.4f" % v for v in turns["lib"]], tc_route,
                       ["%.4f" % v for v in dev_turns["new"]],
                       ["%.4f" % v for v in dev_turns["lib"]], plain_ms,
                       b_ms, b_by))

    # -- 4, training: K2 at the training rows and its whole backward ---------
    hd = FULL["hidden_dim"]
    e_in = FULL["embed_dim"] + hd
    # the cells the training paths run: (entry suffix, params, E, H, what)
    train_cells = (
        [("", params["lstm"], e_in, hd, "AoADetection's cell")]
        + [("_butd_" + tag, bparams[cell], e, bcfg.hidden_dim,
            "BUTD's %s cell" % tag) for tag, cell, e in butd_k2]
        + [("_nic", nparams["lstm"], e_nic, ncfg.hidden_dim, "NIC's cell"),
           ("_aoasp", aparams["lstm"], e_aoasp, acfg.hidden_dim,
            "AoASpatial's cell")])

    def bwd_counts():
        return (fused_lstm.COUNT_BWD.n, fused_lstm.COUNT_BWD_WGMMA.n,
                fused_lstm.COUNT_BWD_TF32X3.n)

    def abs_err(got, want):
        return float((got.float() - want.float()).abs().max())

    def hold_bwd_full(w_cat, b_sum, split, e, hh, m, dtype, what):
        """K2's whole backward (lstm_cell_bwd_full) at B=m on the dtype's
        tensor-core route: three launches (the backward kernel, dx·dh,
        dW·db), the same bits twice, the five outputs within
        holds.k2_bwd_full_errors; then on one backward kernel's output: the
        products' operands (bf16: d_hi + d_lo within 2^-16 |d|; float32:
        d^T's TF32 parts within 2^-21 |d|), and dx·dh and dW·db against
        their plain versions on the same d_gates (float32 against the
        products in float64: dx and dh 1e-5, dW and db 1e-5 of the sums of
        |[x, h]||d| and |d| plus 1e-6; bf16 rtol and atol 1e-2).  -> the
        largest |error| of dx·dh, of dW·db and of the whole backward."""
        dn = str(dtype).split(".")[1]
        route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
        tag = "K2 backward %s %s B=%d E=%d H=%d" % (dn, what, m, e, hh)
        x, h, c, dh, dc = (torch.randn(m, n, generator=gen,
                                       device=dev).to(dtype)
                           for n in (e, hh, hh, hh, hh))
        a7 = (w_cat, b_sum, x, h, c, dh, dc)
        got_route = fused_lstm.lstm_bwd_products_route(w_cat, x, h, c, b_sum,
                                                       dh, dc)
        require(got_route == route, "%s: the products take the %s route"
                % (tag, got_route))
        before, before_p = bwd_counts(), product_counts(fused_lstm)
        full = fused_lstm.lstm_cell_bwd_full(*a7, split)
        torch.cuda.synchronize()
        moved_b = moved(bwd_counts(), before)
        moved_p = moved(product_counts(fused_lstm), before_p)
        require(moved_b == launched(route) and moved_p == launched(route) * 2,
                "%s: the counters moved by %s and %s" % (tag, moved_b,
                                                         moved_p))
        again = fused_lstm.lstm_cell_bwd_full(*a7, split)
        torch.cuda.synchronize()
        require(all(bool(torch.equal(a, b_)) for a, b_ in zip(full, again)),
                "%s: two runs on the same inputs differ" % tag)
        ferr = holds.k2_bwd_full_errors(a7, full)
        require(not max(ferr.values()), "%s: beyond the whole backward's "
                "holds by %s" % (tag, ferr))
        g, _ = fused_lstm._run_bwd_kernel(*a7, route, split, parts=True)
        dx, dhh = fused_lstm._run_dxh_kernel(w_cat, g, x, h, route)
        dw, db = fused_lstm._run_dw_kernel(x, h, g, w_cat, b_sum, route)
        torch.cuda.synchronize()
        d = g.d
        if route == "wgmma":
            beyond_parts = float(((g.hi.float() + g.lo.float() - d).abs()
                                  - 2.0 ** -16 * d.abs()).max())
            dd, tol = d, 1e-2
        else:
            dt = d.t()
            beyond_parts = float(((g.hi[:, :m] + g.lo[:, :m] - dt).abs()
                                  - 2.0 ** -21 * dt.abs()).max())
            dd, tol = d.double(), 1e-5
        require(beyond_parts <= 0, "%s: the products' operands are %.3g "
                "beyond their split's bound" % (tag, beyond_parts))
        pdx, pdh = fused_lstm.lstm_bwd_dxh_plain(w_cat, dd, e)
        pdw, pdb = fused_lstm.lstm_bwd_dw_plain(x, h, dd)
        b_dxh = max(holds._beyond(dx, pdx, tol, tol),
                    holds._beyond(dhh, pdh, tol, tol))
        if route == "tf32x3":
            lim = 1e-5 * (torch.cat([x, h], -1).double().abs().t()
                          @ dd.abs()) + 1e-6
            b_dw = max(holds._beyond(dw, pdw, lim),
                       holds._beyond(db, pdb, 1e-5 * dd.abs().sum(0) + 1e-6))
        else:
            b_dw = max(holds._beyond(dw, pdw, tol, tol),
                       holds._beyond(db, pdb, tol, tol))
        require(not b_dxh and not b_dw, "%s: dx·dh %.3g and dW·db %.3g "
                "beyond their holds" % (tag, b_dxh, b_dw))
        out = dict(dxh=max(abs_err(dx, pdx), abs_err(dhh, pdh)),
                   dw=max(abs_err(dw, pdw), abs_err(db, pdb)),
                   full=max(abs_err(a, b_) for a, b_ in zip(
                       full, fused_lstm.lstm_cell_bwd_full_plain(*a7))))
        log("%s (%s): three launches, the same bits twice, within the "
            "whole backward's holds; max|err| dx·dh %.3g, dW·db %.3g, whole "
            "%.3g (against the float32 plain version)"
            % (tag, route, out["dxh"], out["dw"], out["full"]))
        return out

    def train_cell(suffix, lp, dtype, e, hh, what, bwd_err, prod_err):
        """K2's forward and backward at the training rows (B=128) of one
        cell (its params ``lp`` in ``dtype``, x ``e`` wide): the forward
        and the backward kernel held on the tensor-core route (unless the
        caller gives the backward kernel's errors, ``bwd_err``; the
        products' errors ``prod_err`` come from hold_bwd_full), then timed
        in turns, host-inclusive and device-only: the whole backward
        through LstmCell (three launches), the matmul path (the backward
        kernel and three float32 torch.matmul products, as before the
        product kernels; composed here as a yardstick), torch.lstm_cell's
        backward through autograd (which keeps its gates), the backward
        kernel writing the products' operands, dx·dh, dW·db (float32:
        beside torch.mm(d_gates, w_cat^T), one call of dx·dh's function),
        for AoADetection's cell (suffix "")
        the backward kernel on the CUDA cores, and the forward beside
        torch.lstm_cell's forward.  Entries fused_lstm_cell_bwd_<route>,
        lstm_bwd_dxh_<route>, lstm_bwd_dw_<route> and
        fused_lstm_cell_<route>_train, each with ``suffix`` (and
        fused_lstm_cell_bwd, the CUDA-core backward kernel, for suffix "")."""
        dn = str(dtype).split(".")[1]
        tc_route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
        rate = dn if tc_route == "wgmma" else tc_route
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        w_cat, b_sum, split = fused_lstm.prepare_lstm(lp)
        with_cc = suffix == ""
        x, h, c, dh, dc = (torch.randn(TRAIN_B, n, generator=gen,
                                       device=dev).to(dtype)
                           for n in (e, hh, hh, hh, hh))
        require(fused_lstm.lstm_route(w_cat, x, h) == tc_route
                and fused_lstm.lstm_bwd_route(w_cat, x, h, c, b_sum, dh,
                                              dc) == tc_route,
                "K2 %s %s B=%d takes another route" % (what, dn, TRAIN_B))
        before, before_bwd = counts(fused_lstm), bwd_counts()
        kh, kc = fused_lstm.lstm_cell_fused(w_cat, b_sum, x, h, c, split)
        dg, kdc = fused_lstm.lstm_cell_bwd(w_cat, b_sum, x, h, c, dh, dc,
                                           split)
        torch.cuda.synchronize()
        require(moved(counts(fused_lstm), before) == launched(tc_route)
                and moved(bwd_counts(), before_bwd) == launched(tc_route),
                "K2 %s %s B=%d: the counters moved by %s and %s"
                % (what, dn, TRAIN_B, moved(counts(fused_lstm), before),
                   moved(bwd_counts(), before_bwd)))
        ph, pc = fused_lstm.lstm_cell_plain(w_cat, b_sum, x, h, c)
        pdg, pdc = fused_lstm.lstm_cell_bwd_plain(w_cat, b_sum, x, h, c, dh,
                                                  dc)
        fwd_err = 0.0
        for got, want, name in ((kh, ph, "h'"), (kc, pc, "c'")):
            require(not holds._beyond(got, want, tol, tol),
                    "K2 %s %s B=%d %s: max |err| %.3g beyond rtol and atol "
                    "%g" % (what, dn, TRAIN_B, name, abs_err(got, want), tol))
            fwd_err = max(fwd_err, abs_err(got, want))
        if bwd_err is None:
            for got, want, name in ((dg, pdg, "d_gates"), (kdc, pdc, "dc")):
                require(not holds._beyond(got, want, tol, tol),
                        "K2 backward %s %s B=%d %s: max |err| %.3g beyond "
                        "rtol and atol %g" % (what, dn, TRAIN_B, name,
                                              abs_err(got, want), tol))
            bwd_err = {tc_route: max(abs_err(dg, pdg), abs_err(kdc, pdc))}
        log("K2 %s (%s) %s B=%d E=%d H=%d: forward max|err| %.3g, backward "
            "kernel (d_gates and dc) %.3g (rtol and atol %g)"
            % (dn, tc_route, what, TRAIN_B, e, hh, fwd_err,
               bwd_err[tc_route], tol))
        ours = [t.clone().requires_grad_() for t in (w_cat, b_sum, x, h, c)]
        hn, cn = fused_lstm.LstmCell.apply(*ours, *(split or (None, None)))
        lib_w = [t.clone().requires_grad_() for t in (
            lp["w_ih"].t().contiguous(), lp["w_hh"].t().contiguous(),
            lp["b_ih"], lp["b_hh"])]
        lib_in = [t.clone().requires_grad_() for t in (x, h, c)]
        lh, lc = torch.lstm_cell(lib_in[0], tuple(lib_in[1:]), *lib_w)
        fixed_w = [t.detach() for t in lib_w]
        g, _ = fused_lstm._run_bwd_kernel(w_cat, b_sum, x, h, c, dh, dc,
                                          tc_route, split, parts=True)

        def matmul_path():
            d_gates, kdc_ = fused_lstm._run_bwd_kernel(
                w_cat, b_sum, x, h, c, dh, dc, tc_route, split)
            return fused_lstm.lstm_bwd_products_plain(
                w_cat, b_sum, x, h, d_gates) + (kdc_,)

        fns = {"full": lambda: torch.autograd.grad(
                   (hn, cn), ours, (dh, dc), retain_graph=True),
               "old": matmul_path,
               "lib": lambda: torch.autograd.grad(
                   (lh, lc), lib_in + lib_w, (dh, dc), retain_graph=True),
               "gate": lambda: fused_lstm._run_bwd_kernel(
                   w_cat, b_sum, x, h, c, dh, dc, tc_route, split,
                   parts=True),
               "dxh": lambda: fused_lstm._run_dxh_kernel(w_cat, g, x, h,
                                                         tc_route),
               "dw": lambda: fused_lstm._run_dw_kernel(x, h, g, w_cat, b_sum,
                                                       tc_route),
               "mm": lambda: torch.mm(g.d, w_cat.t()),
               "cc": lambda: fused_lstm._run_bwd_kernel(
                   w_cat, b_sum, x, h, c, dh, dc, "cuda_core"),
               "fwd": lambda: fused_lstm.lstm_cell_fused(
                   w_cat, b_sum, x, h, c, split),
               "lib_fwd": lambda: torch.lstm_cell(x, (h, c), *fixed_w)}
        half = ["full", "old", "lib", "gate", "dxh", "dw"]
        if tc_route == "tf32x3":
            half.append("mm")
        if with_cc:
            half.append("cc")
        order = half + ["fwd", "lib_fwd", "lib_fwd", "fwd"] + half[::-1]
        turns = time_turns(torch, fns, flush, order)
        # autograd's engine takes the host up to about a millisecond to
        # issue a backward: eight times the usual lead keeps the card busy
        # through it, so these readings are the device's alone too
        dev_turns = time_turns(torch, fns, flush, order,
                               lead=8 * DEVICE_LEAD)
        plain = {"gate": time_ms(torch, lambda: fused_lstm.lstm_cell_bwd_plain(
                     w_cat, b_sum, x, h, c, dh, dc), flush),
                 "dxh": time_ms(torch, lambda: fused_lstm.lstm_bwd_dxh_plain(
                     w_cat, g.d, e), flush),
                 "dw": time_ms(torch, lambda: fused_lstm.lstm_bwd_dw_plain(
                     x, h, g.d), flush),
                 "full": time_ms(torch, lambda: fused_lstm
                                 .lstm_cell_bwd_full_plain(
                                     w_cat, b_sum, x, h, c, dh, dc), flush),
                 "fwd": time_ms(torch, lambda: fused_lstm.lstm_cell_plain(
                     w_cat, b_sum, x, h, c), flush)}
        item = x.element_size()
        bnd = k2_bwd_bounds(TRAIN_B, e, hh, item, tc_route)
        wbytes = ((e + hh) * 4 * hh + 4 * hh) * item
        fwd_b = bound(TRAIN_B * (e + 4 * hh) * item + wbytes,
                      2 * TRAIN_B * (e + hh) * 4 * hh, rate)
        m_ = lambda name, t=turns: mean(t[name])          # noqa: E731
        src = "simpleimagecaptionzoo_tpu_torch/csrc/"
        rep = "simpleimagecaptionzoo_tpu/ops/pallas_lstm.py:455"
        shape = "B=%d E=%d H=%d (%s, training)" % (TRAIN_B, e, hh, what)
        whole = dict(
            full_backward_ms=m_("full"),
            device_full_backward_ms=m_("full", dev_turns),
            full_backward_plain_ms=plain["full"],
            full_backward_bound_ms=bnd["full"][0],
            full_backward_bound_by=bnd["full"][1],
            saved_gates_bound_ms=bnd["saved"][0],
            matmul_path_ms=m_("old"),
            device_matmul_path_ms=m_("old", dev_turns),
            lstm_cell_backward_ms=m_("lib"),
            device_lstm_cell_backward_ms=m_("lib", dev_turns),
            whole_is="the whole backward through LstmCell (the backward "
                     "kernel, dx·dh and dW·db); matmul_path: the backward "
                     "kernel and float32 torch.matmul products; "
                     "lstm_cell_backward: torch.lstm_cell's backward "
                     "through autograd (it keeps its gates)")
        if with_cc:
            cc_b = bound(bnd["gate_cc"][2], bnd["gate_cc"][3], dn)
            entry("fused_lstm_cell_bwd", dn,
                  max_abs_err=bwd_err["cuda_core"],
                  max_err=bwd_err["cuda_core"], ms=m_("cc"),
                  kernel_ms=m_("cc"), device_ms=m_("cc", dev_turns),
                  plain_ms=plain["gate"], bound_ms=cc_b[0],
                  bound_by=cc_b[1], library_ms=None, kernel_route="cuda_core",
                  source=src + "fused_lstm.cu", replaces=rep, shape=shape)
        entry("fused_lstm_cell_bwd_" + tc_route + suffix, dn,
              max_abs_err=bwd_err[tc_route], max_err=bwd_err[tc_route],
              ms=m_("gate"), kernel_ms=m_("gate"),
              device_ms=m_("gate", dev_turns), plain_ms=plain["gate"],
              bound_ms=bnd["gate"][0], bound_by=bnd["gate"][1],
              library_ms=None, kernel_route=tc_route, turns=turns,
              device_turns=dev_turns, source=src + "fused_lstm.cu",
              replaces=rep, shape=shape, **whole)
        entry("lstm_bwd_dxh_" + tc_route + suffix, dn,
              max_abs_err=prod_err["dxh"], max_err=prod_err["dxh"],
              ms=m_("dxh"), kernel_ms=m_("dxh"),
              device_ms=m_("dxh", dev_turns), plain_ms=plain["dxh"],
              bound_ms=bnd["dxh"][0], bound_by=bnd["dxh"][1],
              library_ms=m_("mm") if tc_route == "tf32x3" else None,
              device_library_ms=(m_("mm", dev_turns)
                                 if tc_route == "tf32x3" else None),
              library_is="torch.mm(d_gates, w_cat.t()), float32, TF32 off "
                         "(bf16: none, no one call takes float32 d_gates "
                         "and a bf16 w_cat)",
              splits=fused_lstm.dxh_splits(TRAIN_B, e, hh,
                                           fused_lstm._sms(dev), tc_route),
              kernel_route=tc_route, source=src + "lstm_bwd.cu",
              replaces=rep, shape=shape)
        entry("lstm_bwd_dw_" + tc_route + suffix, dn,
              max_abs_err=prod_err["dw"], max_err=prod_err["dw"],
              ms=m_("dw"), kernel_ms=m_("dw"),
              device_ms=m_("dw", dev_turns), plain_ms=plain["dw"],
              bound_ms=bnd["dw"][0], bound_by=bnd["dw"][1], library_ms=None,
              library_is="none: [x, h] is two tensors, and db a second "
                         "output",
              kernel_route=tc_route, source=src + "lstm_bwd.cu",
              replaces=rep, shape=shape)
        entry("fused_lstm_cell_%s_train%s" % (tc_route, suffix), dn,
              max_abs_err=fwd_err, max_err=fwd_err, ms=m_("fwd"),
              kernel_ms=m_("fwd"), device_ms=m_("fwd", dev_turns),
              plain_ms=plain["fwd"], bound_ms=fwd_b[0], bound_by=fwd_b[1],
              library_ms=m_("lib_fwd"),
              device_library_ms=m_("lib_fwd", dev_turns),
              kernel_route=tc_route, source=src + "fused_lstm.cu",
              replaces="simpleimagecaptionzoo_tpu/ops/pallas_lstm.py:166",
              shape=shape)
        fmt = lambda name, t: ["%.4f" % v for v in t.get(name, [])]  # noqa
        log("K2 backward %s %s B=%d E=%d in turns (%s), device alone: the "
            "whole backward %s ms, the matmul path %s, torch.lstm_cell's "
            "backward %s; the backward kernel %s, dx·dh %s, dW·db %s%s%s; "
            "host-inclusive: whole %s, matmul path %s, torch.lstm_cell's "
            "%s; plain: whole %.4f, backward kernel %.4f, dx·dh %.4f, dW·db "
            "%.4f ms; bounds: whole %.4f (%s), kernel %.4f, dx·dh %.4f, "
            "dW·db %.4f ms"
            % (what, dn, TRAIN_B, e, ", ".join(order),
               fmt("full", dev_turns), fmt("old", dev_turns),
               fmt("lib", dev_turns), fmt("gate", dev_turns),
               fmt("dxh", dev_turns), fmt("dw", dev_turns),
               ", torch.mm %s" % fmt("mm", dev_turns)
               if tc_route == "tf32x3" else "",
               ", the kernel on the CUDA cores %s" % fmt("cc", dev_turns)
               if with_cc else "",
               fmt("full", turns), fmt("old", turns), fmt("lib", turns),
               plain["full"], plain["gate"], plain["dxh"], plain["dw"],
               bnd["full"][0], bnd["full"][1], bnd["gate"][0],
               bnd["dxh"][0], bnd["dw"][0]))
        log("K2 %s %s B=%d E=%d forward in the same turns: %s %s ms, "
            "torch.lstm_cell %s; device alone: %s, torch.lstm_cell %s ms; "
            "plain %.4f ms; bound %.4f ms (%s)"
            % (what, dn, TRAIN_B, e, tc_route, fmt("fwd", turns),
               fmt("lib_fwd", turns), fmt("fwd", dev_turns),
               fmt("lib_fwd", dev_turns), plain["fwd"], fwd_b[0], fwd_b[1]))
        del hn, cn, lh, lc, ours, lib_in, lib_w, g

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        tc_route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        lp = steps._cast_floats(params["lstm"], dtype)
        w_cat, b_sum, split = fused_lstm.prepare_lstm(lp)
        w200 = ((torch.rand(200 + hd, 4 * hd, generator=gen, device=dev) * 2
                 - 1) / hd ** 0.5).to(dtype)
        split200 = (tf32.prepare_split(w200)
                    if dtype == torch.float32 else None)

        def beyond(got, want, what):
            require(not holds._beyond(got, want, tol, tol),
                    "%s %s: max |err| %.3g beyond rtol and atol %g"
                    % (what, dn, abs_err(got, want), tol))
            return abs_err(got, want)

        # the backward kernel on each route at the training rows, the
        # decode rows and the unaligned E=200
        bwd_err = {tc_route: 0.0, "cuda_core": 0.0}
        for m, e, wc, sp in ((TRAIN_B, e_in, w_cat, split),
                             (B, e_in, w_cat, split),
                             (TRAIN_B, 200, w200, split200)):
            x, h, c, dh, dc = (torch.randn(m, n, generator=gen,
                                           device=dev).to(dtype)
                               for n in (e, hd, hd, hd, hd))
            pdg, pdc = fused_lstm.lstm_cell_bwd_plain(wc, b_sum, x, h, c, dh,
                                                      dc)
            for route in (tc_route, "cuda_core"):
                before = bwd_counts()
                if route == tc_route:
                    got_route = fused_lstm.lstm_bwd_route(wc, x, h, c, b_sum,
                                                          dh, dc)
                    require(got_route == route, "K2 backward %s B=%d E=%d "
                            "takes the %s route" % (dn, m, e, got_route))
                    dg, kdc = fused_lstm.lstm_cell_bwd(wc, b_sum, x, h, c,
                                                       dh, dc, sp)
                else:
                    dg, kdc = fused_lstm._run_bwd_kernel(wc, b_sum, x, h, c,
                                                         dh, dc, route)
                torch.cuda.synchronize()
                require(moved(bwd_counts(), before) == launched(route),
                        "K2 backward %s %s B=%d E=%d: the counters moved by "
                        "%s" % (dn, route, m, e, moved(bwd_counts(), before)))
                what = "K2 backward (%s) B=%d E=%d" % (route, m, e)
                err = max(beyond(dg, pdg, what + " d_gates"),
                          beyond(kdc, pdc, what + " dc"))
                bwd_err[route] = max(bwd_err[route], err)
                log("K2 backward %s (%s) B=%d E=%d H=%d: d_gates and dc "
                    "max|err| %.3g (rtol %g atol %g)"
                    % (dn, route, m, e, hd, err, tol, tol))
        # the whole backward where E=200 keeps its products off the tensor
        # cores: the backward kernel on its own route, float32 torch.matmul
        # products, no product kernel
        x, h, c, dh, dc = (torch.randn(TRAIN_B, n, generator=gen,
                                       device=dev).to(dtype)
                           for n in (200, hd, hd, hd, hd))
        a200 = (w200, b_sum, x, h, c, dh, dc)
        require(fused_lstm.lstm_bwd_products_route(w200, x, h, c, b_sum, dh,
                                                   dc) == "cuda_core",
                "K2 backward %s E=200: the products take the tensor cores"
                % dn)
        before, before_p = bwd_counts(), product_counts(fused_lstm)
        full = fused_lstm.lstm_cell_bwd_full(*a200, split200)
        torch.cuda.synchronize()
        require(moved(bwd_counts(), before) == launched(tc_route)
                and moved(product_counts(fused_lstm), before_p) == (0,) * 6,
                "K2 backward %s E=200: the counters moved by %s and %s"
                % (dn, moved(bwd_counts(), before),
                   moved(product_counts(fused_lstm), before_p)))
        ferr = holds.k2_bwd_full_errors(a200, full)
        require(not max(ferr.values()), "K2 backward %s E=200 (cuda_core "
                "products): beyond the whole backward's holds by %s"
                % (dn, ferr))
        log("K2 backward %s B=%d E=200: the backward kernel on %s and "
            "float32 torch.matmul products (route cuda_core), within the "
            "whole backward's holds" % (dn, TRAIN_B, tc_route))
        # the products at every training cell, at the XE and SCST rows and
        # the engine's eval rows, then each cell timed at B=128
        for suffix, cp, e, hh, what in train_cells:
            lpc = steps._cast_floats(cp, dtype)
            wc, bs, sp = (w_cat, b_sum, split) if suffix == "" else \
                fused_lstm.prepare_lstm(lpc)
            prod_err = dict(dxh=0.0, dw=0.0, full=0.0)
            for m in K2_BWD_ROWS:
                errs = hold_bwd_full(wc, bs, sp, e, hh, m, dtype, what)
                prod_err = {k: max(v, errs[k]) for k, v in prod_err.items()}
            train_cell(suffix, lpc, dtype, e, hh, what,
                       bwd_err if suffix == "" else None, prod_err)

    log("-- phase 5 at %.1f s" % (time.time() - t_start))
    # -- 5. K3 against its plain version --------------------------------------
    qparams = model.quantize_decode_params(params)
    hd = FULL["hidden_dim"]
    e_lstm = FULL["embed_dim"] + 2 * hd
    ragged = quant.quantize_dense({
        "w": torch.rand(200, 700, generator=gen, device=dev) * 2 - 1,
        "b": torch.randn(700, generator=gen, device=dev)})
    k3_steps = [("lstm", qparams["lstm"], B, e_lstm),
                ("aoa_dec.q", qparams["aoa_dec"]["q"], B, hd),
                ("aoa_dec.aoa", qparams["aoa_dec"]["aoa"], B, 2 * hd)]
    k3_beam = [(what, qp, mb, k) for what, qp, _, k in k3_steps]
    k3_cases = k3_steps + [("ragged", ragged, 37, 200)]
    bq = butd.quantize_decode_params(bparams)
    nq = nic.quantize_decode_params(nparams)
    aq = aoasp.quantize_decode_params(aparams)
    # the other families' int8 step shapes (phases 10-13): (what, layer, K)
    # with K the width of x: each cell's [x, h], BUTD's att_dec, AoASpatial's
    # aoa_dec.q and aoa_dec.aoa
    k3_more = [(what, qp, m, k) for what, qp, k in [
        ("butd." + tag, bq[layer], k) for tag, layer, k in butd_k3] + [
        ("nic.lstm", nq["lstm"], e_nic + ncfg.hidden_dim),
        ("aoasp.lstm", aq["lstm"], e_aoasp + acfg.hidden_dim),
        ("aoasp.q", aq["aoa_dec"]["q"], acfg.hidden_dim),
        ("aoasp.aoa", aq["aoa_dec"]["aoa"], 2 * acfg.hidden_dim)]
        for m in (B, mb)]
    more_whats = {what for what, *_ in k3_more}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        tc_route = "wgmma" if dtype == torch.bfloat16 else "tf32x2"
        rate = dn if tc_route == "wgmma" else tc_route     # for bound()
        # the tensor-core route (quant_route's pick) and, forced, the
        # CUDA-core route, which operands TMA cannot take go to, at every
        # shape: the greedy and beam rows and the ragged one
        cases = [c + (route,) for route in (tc_route, "cuda_core")
                 for c in k3_cases + k3_beam + k3_more]
        errs = {tc_route: 0.0, "cuda_core": 0.0}
        case_err = {}          # (what, m, route) -> max |err|
        for what, qp, m, k, route in cases:
            n = qp["s"].shape[0]
            x = (0.5 * torch.randn(m, k, generator=gen, device=dev)).to(dtype)
            before = counts(quant, "tf32x2")
            if route == tc_route:
                got_route = quant.quant_route(x, qp["q"])
                require(got_route == route, "K3 %s %s m=%d K=%d takes the %s "
                        "route" % (dn, what, m, k, got_route))
                got = quant.quant_matmul(x, qp)
            else:
                got = quant._run_kernel(x, qp["q"], qp["s"], qp["b"], route)
            torch.cuda.synchronize()
            delta = moved(counts(quant, "tf32x2"), before)
            require(delta == launched(route, tf32="tf32x2"),
                    "K3 %s %s %s: the counters moved by %s"
                    % (dn, route, what, delta))
            want = quant.quant_matmul_plain(x, qp)
            diff = (got.float() - want.float()).abs()
            if dtype == torch.float32:
                # the sums run in another order: 1e-5 of the sum of |terms|,
                # the float32 rounding bound of a dot product
                lim = 1e-5 * (x.abs() @ (qp["q"][:k, :n].float().abs()
                                         * qp["s"])) + 1e-6
                tol_s = "1e-5 of sum |x q s|"
            else:
                lim = 1e-2 + 1e-2 * want.float().abs()   # one bf16 ulp
                tol_s = "rtol 1e-2 atol 1e-2"
            require(got.shape == (m, n) and got.dtype == dtype
                    and bool((diff <= lim).all()),
                    "K3 %s %s %s m=%d K=%d n=%d: max |err| %.3g beyond %s"
                    % (dn, route, what, m, k, n, float(diff.max()), tol_s))
            case_err[what, m, route] = float(diff.max())
            if what not in more_whats:
                errs[route] = max(errs[route], float(diff.max()))
            log("K3 %s (%s) %s m=%d K=%d (Kp %d) n=%d (Np %d): max|err| %.3g "
                "(%s; largest share of the hold %.3g)"
                % (dn, route, what, m, k, qp["q"].shape[0], n,
                   qp["q"].shape[1], float(diff.max()), tol_s,
                   float((diff / lim).max())))
        item = torch.tensor([], dtype=dtype).element_size()
        shapes = {(r, m): [] for r in (tc_route, "cuda_core") for m in (B, mb)}
        for what, qp, m, k in k3_steps + k3_beam:
            n = qp["s"].shape[0]
            x = (0.5 * torch.randn(m, k, generator=gen, device=dev)).to(dtype)
            nbytes = m * k * item + k * n + 2 * n * 4 + m * n * item
            tc_bound = bound(nbytes, 2 * m * k * n, rate)
            old_bound = bound(nbytes, 2 * m * k * n, dn)
            # float32: the 2xTF32 scheme's own rate, beside the bound
            scheme = ({"scheme_bound_ms": bound(nbytes, 2 * m * k * n,
                                                "2xtf32")[0]}
                      if tc_route == "tf32x2" else {})
            plain_ms = time_ms(torch, lambda: quant.quant_matmul_plain(x, qp),
                               flush)
            # the library yardstick: x @ (q s)^T without the bias
            q_t = qp["q"][:k, :n].t().contiguous()
            s_x = qp["s"].to(dtype)
            fns = {"old": lambda: quant._run_kernel(x, qp["q"], qp["s"],
                                                    qp["b"], "cuda_core"),
                   "new": lambda: quant.quant_matmul(x, qp),
                   "lib": lambda: torch._weight_int8pack_mm(x, q_t, s_x)}
            order = ["old", "new", "lib", "lib", "new", "old"]
            turns = time_turns(torch, fns, flush, order)
            dev_turns = time_turns(torch, fns, flush, order, lead=DEVICE_LEAD)
            common = dict(what=what, shape="m=%d K=%d n=%d" % (m, k, n),
                          plain_ms=plain_ms, library_ms=mean(turns["lib"]),
                          device_library_ms=mean(dev_turns["lib"]))
            for route, key, (b_ms, b_by) in (("cuda_core", "old", old_bound),
                                             (tc_route, "new", tc_bound)):
                shapes[route, m].append(dict(
                    common, bound_ms=b_ms, bound_by=b_by,
                    **(scheme if route == tc_route else {}),
                    ms=mean(turns[key]), turns=turns[key],
                    device_ms=mean(dev_turns[key]),
                    device_turns=dev_turns[key]))
            log("K3 %s %s m=%d K=%d n=%d timing in turns (%s): %s %s ms, "
                "cuda_core %s ms, torch._weight_int8pack_mm %s ms; device "
                "alone: %s %s, cuda_core %s, library %s ms; plain %.4f ms; "
                "bound %.4f ms (%s; %sthe CUDA-core rate's %.4f)"
                % (dn, what, m, k, n, ", ".join(order), tc_route,
                   ["%.4f" % t for t in turns["new"]],
                   ["%.4f" % t for t in turns["old"]],
                   ["%.4f" % t for t in turns["lib"]], tc_route,
                   ["%.4f" % t for t in dev_turns["new"]],
                   ["%.4f" % t for t in dev_turns["old"]],
                   ["%.4f" % t for t in dev_turns["lib"]], plain_ms,
                   tc_bound[0], tc_bound[1],
                   "".join("2xTF32's %.4f, " % v for v in scheme.values()),
                   old_bound[0]))
        # the CUDA-core route's entry at the greedy rows, the tensor-core
        # route's at the greedy rows and at the beam rows
        for route, m in (("cuda_core", B), (tc_route, B), (tc_route, mb)):
            first = shapes[route, m][0]                  # the LSTM gates
            ename = ("quant_matmul" if route == "cuda_core"
                     else "quant_matmul_" + route)
            extra = (dict(old_route_ms=shapes["cuda_core", m][0]["ms"],
                          device_old_route_ms=shapes["cuda_core", m][0][
                              "device_ms"],
                          old_route_bound_ms=shapes["cuda_core", m][0][
                              "bound_ms"],
                          old_route_max_abs_err=errs["cuda_core"])
                     if route != "cuda_core" else {})
            entry(ename + ("_beam" if m == mb else ""), dn,
                  source="simpleimagecaptionzoo_tpu_torch/csrc/quant_matmul.cu",
                  replaces="simpleimagecaptionzoo_tpu/ops/quant.py:105",
                  max_abs_err=errs[route], max_err=errs[route],
                  ms=first["ms"], kernel_ms=first["ms"],
                  device_ms=first["device_ms"], plain_ms=first["plain_ms"],
                  bound_ms=first["bound_ms"], bound_by=first["bound_by"],
                  **{k: first[k] for k in ("scheme_bound_ms",) if k in first},
                  library_ms=first["library_ms"], kernel_route=route,
                  shape=first["shape"] + " (the LSTM gates)",
                  shapes=shapes[route, m], **extra)

        # the other families' int8 step shapes, timed in turns as above;
        # 10 launches a reading, as torch._weight_int8pack_mm takes up to
        # 50 ms a call at BUTD's shapes
        for what, qp, m, k in k3_more:
            n = qp["s"].shape[0]
            x = (0.5 * torch.randn(m, k, generator=gen, device=dev)).to(dtype)
            nbytes = m * k * item + k * n + 2 * n * 4 + m * n * item
            b_ms, b_by = bound(nbytes, 2 * m * k * n, rate)
            scheme = ({"scheme_bound_ms": bound(nbytes, 2 * m * k * n,
                                                "2xtf32")[0]}
                      if tc_route == "tf32x2" else {})
            plain_ms = time_ms(torch, lambda: quant.quant_matmul_plain(x, qp),
                               flush)
            q_t = qp["q"][:k, :n].t().contiguous()
            s_x = qp["s"].to(dtype)
            fns = {"old": lambda: quant._run_kernel(x, qp["q"], qp["s"],
                                                    qp["b"], "cuda_core"),
                   "new": lambda: quant.quant_matmul(x, qp),
                   "lib": lambda: torch._weight_int8pack_mm(x, q_t, s_x)}
            order = ["old", "new", "lib", "new", "old"]
            turns = time_turns(torch, fns, flush, order, reps=10)
            dev_turns = time_turns(torch, fns, flush, order, reps=10,
                                   lead=DEVICE_LEAD)
            err = case_err[what, m, tc_route]
            entry("quant_matmul_%s_%s%s" % (tc_route, what.replace(".", "_"),
                                            "_beam" if m == mb else ""), dn,
                  source="simpleimagecaptionzoo_tpu_torch/csrc/quant_matmul.cu",
                  replaces="simpleimagecaptionzoo_tpu/ops/quant.py:105",
                  max_abs_err=err, max_err=err, ms=mean(turns["new"]),
                  kernel_ms=mean(turns["new"]),
                  device_ms=mean(dev_turns["new"]), plain_ms=plain_ms,
                  bound_ms=b_ms, bound_by=b_by, **scheme,
                  library_ms=mean(turns["lib"]),
                  device_library_ms=mean(dev_turns["lib"]),
                  kernel_route=tc_route, turns=turns["new"],
                  device_turns=dev_turns["new"],
                  old_route_ms=mean(turns["old"]),
                  device_old_route_ms=mean(dev_turns["old"]),
                  old_route_max_abs_err=case_err[what, m, "cuda_core"],
                  shape="m=%d K=%d n=%d (%s)" % (m, k, n, what))
            log("K3 %s %s m=%d K=%d n=%d timing in turns (%s): %s %s ms, "
                "cuda_core %s ms, torch._weight_int8pack_mm %s ms; device "
                "alone: %s %s, cuda_core %s, library %s ms; plain %.4f ms; "
                "bound %.4f ms (%s%s)"
                % (dn, what, m, k, n, ", ".join(order), tc_route,
                   ["%.4f" % t for t in turns["new"]],
                   ["%.4f" % t for t in turns["old"]],
                   ["%.4f" % t for t in turns["lib"]], tc_route,
                   ["%.4f" % t for t in dev_turns["new"]],
                   ["%.4f" % t for t in dev_turns["old"]],
                   ["%.4f" % t for t in dev_turns["lib"]], plain_ms, b_ms,
                   b_by, "".join("; 2xTF32's %.4f" % v
                                 for v in scheme.values())))

    log("-- phase 6 at %.1f s" % (time.time() - t_start))
    # -- 6. K1-int8 against its plain version ---------------------------------
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        tc_route = "wgmma" if dtype == torch.bfloat16 else "tf32x2"
        rate = dn if tc_route == "wgmma" else tc_route     # for bound()
        tol = 1e-4 if dtype == torch.float32 else 2e-3
        head = fused_head.prepare_head(qparams["predict"], dtype)
        require(head.w.dtype == torch.int8, "K1-int8: head weight is %s"
                % head.w.dtype)
        x = (0.5 * torch.randn(B, hd, generator=gen, device=dev)).to(dtype)
        xb = (0.5 * torch.randn(mb, hd, generator=gen, device=dev)).to(dtype)
        route = fused_head.head_route(head.w, x)
        require(route == tc_route, "K1-int8 %s takes the %s route"
                % (dn, route))
        before = counts(fused_head, "tf32x2")
        err = hold_head(torch, fused_head, "K1-int8/" + route, head, x, dn,
                        tol, extra=[(xb, 3)])
        delta = moved(counts(fused_head, "tf32x2"), before)
        require(delta == launched(tc_route, 4, tf32="tf32x2"),
                "K1-int8 %s: the counters moved by %s" % (dn, delta))
        # the CUDA-core route, which int8 heads TMA cannot take go to
        before = counts(fused_head, "tf32x2")
        old_err = hold_head(torch, fused_head, "K1-int8/cuda_core", head, x,
                            dn, tol, extra=[(xb, 3)], route="cuda_core")
        delta = moved(counts(fused_head, "tf32x2"), before)
        require(delta == launched("cuda_core", 4, tf32="tf32x2"),
                "K1-int8 %s forced onto the cuda_core route: the counters "
                "moved by %s" % (dn, delta))
        item = x.element_size()

        def k1i_bound(m, k, rate):
            nbytes = (m * hd * item + hd * head.v + 2 * head.v * 4
                      + m * (k * 8 + 4))
            return bound(nbytes, 2 * m * hd * head.v, rate)

        b_ms, b_by = k1i_bound(B, 1, rate)
        bb_ms, bb_by = k1i_bound(mb, 3, rate)
        # float32: the 2xTF32 scheme's own rate, beside the bound
        scheme = ({"scheme_bound_ms": k1i_bound(B, 1, "2xtf32")[0],
                   "beam_scheme_bound_ms": k1i_bound(mb, 3, "2xtf32")[0]}
                  if tc_route == "tf32x2" else {})
        plain_ms = time_ms(torch,
                           lambda: fused_head.topk_head_plain(head, x, 1),
                           flush)
        beam_plain_ms = time_ms(
            torch, lambda: fused_head.topk_head_plain(head, xb, 3), flush)
        fns = {"old": lambda: fused_head._run_kernel(head, x, 1, "cuda_core"),
               "new": lambda: fused_head.topk_head(head, x, 1)}
        beam_fns = {
            "old": lambda: fused_head._run_kernel(head, xb, 3, "cuda_core"),
            "new": lambda: fused_head.topk_head(head, xb, 3)}
        order = ["old", "new", "new", "old"]
        turns = time_turns(torch, fns, flush, order)
        dev_turns = time_turns(torch, fns, flush, order, lead=DEVICE_LEAD)
        beam = time_turns(torch, beam_fns, flush, order)
        dev_beam = time_turns(torch, beam_fns, flush, order, lead=DEVICE_LEAD)
        common = dict(source="simpleimagecaptionzoo_tpu_torch/csrc/"
                      "fused_head.cu",
                      replaces="simpleimagecaptionzoo_tpu/ops/fused_head.py:155",
                      plain_ms=plain_ms, library_ms=None,
                      shape="m=%d K=%d V=%d int8 W (padded %dx%d) k=1"
                      % (B, hd, head.v, *head.w.shape))
        ob_ms, ob_by = k1i_bound(B, 1, dn)
        entry("fused_head_topk_int8", dn, max_abs_err=old_err,
              max_err=old_err, ms=mean(turns["old"]),
              kernel_ms=mean(turns["old"]),
              device_ms=mean(dev_turns["old"]), bound_ms=ob_ms,
              bound_by=ob_by, kernel_route="cuda_core",
              beam_ms=mean(beam["old"]), beam_device_ms=mean(dev_beam["old"]),
              beam_bound_ms=k1i_bound(mb, 3, dn)[0], **common)
        tc_name = ("fused_head_topk_int8_wgmma" if tc_route == "wgmma"
                   else "fused_head_topk_tf32x2")
        entry(tc_name, dn, max_abs_err=err, max_err=err,
              ms=mean(turns["new"]), kernel_ms=mean(turns["new"]),
              bound_ms=b_ms, bound_by=b_by, kernel_route=tc_route,
              turns=turns, old_route_ms=mean(turns["old"]),
              old_route_max_abs_err=old_err, old_route_bound_ms=ob_ms,
              device_turns=dev_turns, device_ms=mean(dev_turns["new"]),
              device_old_route_ms=mean(dev_turns["old"]),
              beam_shape="m=%d k=3" % mb, beam_turns=beam,
              beam_ms=mean(beam["new"]), beam_old_route_ms=mean(beam["old"]),
              beam_device_turns=dev_beam, beam_device_ms=mean(dev_beam["new"]),
              beam_bound_ms=bb_ms, **scheme, **common)
        entry(tc_name + "_beam", dn, max_abs_err=err, max_err=err,
              ms=mean(beam["new"]), kernel_ms=mean(beam["new"]),
              device_ms=mean(dev_beam["new"]),
              old_route_ms=mean(beam["old"]),
              device_old_route_ms=mean(dev_beam["old"]),
              plain_ms=beam_plain_ms, bound_ms=bb_ms, bound_by=bb_by,
              **{k[5:]: v for k, v in scheme.items() if k.startswith("beam_")},
              library_ms=None, kernel_route=tc_route,
              shape="m=%d K=%d V=%d int8 W k=3" % (mb, hd, head.v),
              source=common["source"], replaces=common["replaces"])
        log("K1-int8 %s timing in turns (old, new, new, old): %s %s ms, "
            "cuda_core %s ms; device alone: %s %s, cuda_core %s ms; plain "
            "%.4f ms; bound %.4f ms (%s; %sthe CUDA-core rate's %.4f)"
            % (dn, tc_route, ["%.4f" % t for t in turns["new"]],
               ["%.4f" % t for t in turns["old"]], tc_route,
               ["%.4f" % t for t in dev_turns["new"]],
               ["%.4f" % t for t in dev_turns["old"]], plain_ms, b_ms, b_by,
               "".join("2xTF32's %.4f, " % scheme[k]
                       for k in ("scheme_bound_ms",) if k in scheme),
               ob_ms))
        log("K1-int8 %s at m=%d k=3 in turns: %s %s ms, cuda_core %s ms; "
            "device alone: %s %s, cuda_core %s ms; plain %.4f ms; bound "
            "%.4f ms (%s%s)"
            % (dn, mb, tc_route, ["%.4f" % t for t in beam["new"]],
               ["%.4f" % t for t in beam["old"]], tc_route,
               ["%.4f" % t for t in dev_beam["new"]],
               ["%.4f" % t for t in dev_beam["old"]], beam_plain_ms, bb_ms,
               bb_by, "".join("; 2xTF32's %.4f" % scheme[k]
                              for k in ("beam_scheme_bound_ms",)
                              if k in scheme)))
        # the 512-wide families' int8 heads
        for fam, fq, fcfg in (("nic", nq, ncfg), ("aoasp", aq, acfg)):
            head_at(fam, fused_head.prepare_head(fq["predict"], dtype),
                    fcfg.hidden_dim, dtype, tc_route, rate, tc_name)

    # the tie across chunks with an int8 head, on both routes of each dtype
    # (3 and 1 are exact int8 values; scale 1, bias 0)
    q = torch.zeros((128, 2 * fused_head.V_TILE), dtype=torch.int8,
                    device=dev)
    q[:8, 7] = 3
    q[:8, fused_head.V_TILE + 11] = 3
    q[:8, 100] = 1
    for dtype, route in ((torch.float32, "tf32x2"),
                         (torch.float32, "cuda_core"),
                         (torch.bfloat16, "wgmma"),
                         (torch.bfloat16, "cuda_core")):
        tie_head = fused_head.prepare_head(
            {"q": q, "s": torch.ones(700, device=dev),
             "b": torch.zeros(700, device=dev)}, dtype)
        eye = torch.eye(8, 128, device=dev, dtype=dtype)
        if route == fused_head.head_route(tie_head.w, eye):
            _, ti, tl = fused_head.topk_head(tie_head, eye, 3)
        else:
            _, ti, tl = fused_head._run_kernel(tie_head, eye, 3, route)
        _, pi, pl = fused_head.topk_head_plain(tie_head, eye, 3)
        require(ti.tolist() == [[7, fused_head.V_TILE + 11, 100]] * 8
                and torch.equal(ti, pi) and bool(torch.isfinite(tl).all())
                and float((tl - pl).abs().max()) <= 1e-4,
                "K1-int8 tie case %s %s: %s" % (dtype, route, ti.tolist()))
        log("K1-int8 tie across chunks, %s %s route: ids %s, lse finite"
            % (str(dtype).split(".")[1], route, ti[0].tolist()))

    log("-- phase 7 at %.1f s" % (time.time() - t_start))
    # -- 7. K4 against its plain version --------------------------------------
    n_valid = 10 + torch.arange(B, device=dev) % (N_BOX - 9)   # 10..36 boxes
    box_mask = (torch.arange(N_BOX, device=dev)[None, :]
                < n_valid[:, None]).float()
    heads = FULL["num_heads"]
    kq, ks = int8_attention.quantize_rows(
        torch.randn(B, N_BOX, hd, generator=gen, device=dev))
    vq, vs = int8_attention.quantize_rows(
        torch.randn(B, N_BOX, hd, generator=gen, device=dev))
    k4_counts = lambda: (int8_attention.COUNT.n, int8_attention.COUNT_TMA.n)
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        errs = {"tma": 0.0, "cuda_core": 0.0}
        item = torch.tensor([], dtype=dtype).element_size()
        timed = {}
        for k in (1, 3):
            q = torch.randn(B, k, hd, generator=gen, device=dev).to(dtype)
            route = int8_attention.attention_route(q, kq, vq, N_BOX, hd, heads)
            require(route == "tma", "K4 %s k=%d takes the %s route"
                    % (dn, k, route))
            pout, ppm = int8_attention.lanes_attention_int8_plain(
                q, kq, ks, vq, vs, box_mask, heads)
            for r in ("tma", "cuda_core"):
                before = k4_counts()
                if r == route:
                    out, pm = int8_attention.lanes_attention_int8(
                        q, kq, ks, vq, vs, box_mask, heads)
                else:
                    out, pm = int8_attention._run_kernel(
                        q, kq, ks, vq, vs, box_mask, heads, r)
                torch.cuda.synchronize()
                require(moved(k4_counts(), before) == (1, int(r == "tma")),
                        "K4 %s %s k=%d: the counters moved by %s"
                        % (dn, r, k, moved(k4_counts(), before)))
                d_out = (out.float() - pout.float()).abs()
                lim = (2e-5 if dtype == torch.float32
                       else 1e-2 + 1e-2 * pout.float().abs())
                e_pm = float((pm - ppm).abs().max())
                masked = pm.masked_select((box_mask == 0)[:, None, :]
                                          .expand_as(pm))
                require(out.dtype == dtype and bool((d_out <= lim).all())
                        and e_pm <= 2e-6 and bool((masked == 0).all()),
                        "K4 %s %s k=%d: out max |err| %.3g, pmean %.3g, "
                        "masked max %.3g" % (dn, r, k, float(d_out.max()), e_pm,
                                             float(masked.abs().max())))
                errs[r] = max(errs[r], float(d_out.max()), e_pm)
                log("K4 %s (%s) B=%d k=%d N=%d heads=%d: out max|err| %.3g, "
                    "pmean %.3g (tol %s / 2e-6), masked boxes exactly 0"
                    % (dn, r, B, k, N_BOX, heads, float(d_out.max()), e_pm,
                       "2e-5" if dtype == torch.float32 else "rtol/atol 1e-2"))

            def k4(route, q=q):
                if route == "tma":
                    return lambda: int8_attention.lanes_attention_int8(
                        q, kq, ks, vq, vs, box_mask, heads)
                return lambda: int8_attention._run_kernel(
                    q, kq, ks, vq, vs, box_mask, heads, route)

            fns = {"old": k4("cuda_core"), "new": k4("tma")}
            order = ["old", "new", "new", "old"]
            nbytes = (2 * B * k * hd * item + 2 * B * N_BOX * hd
                      + 3 * B * N_BOX * 4 + B * k * N_BOX * 4)
            timed[k] = dict(
                turns=time_turns(torch, fns, flush, order),
                dev_turns=time_turns(torch, fns, flush, order,
                                     lead=DEVICE_LEAD),
                plain_ms=time_ms(torch, lambda q=q: (
                    int8_attention.lanes_attention_int8_plain(
                        q, kq, ks, vq, vs, box_mask, heads)), flush),
                bound=bound(nbytes, 4 * B * k * N_BOX * hd, "float32"))
        g, bm = timed[1], timed[3]
        common = dict(
            source="simpleimagecaptionzoo_tpu_torch/csrc/int8_attention.cu",
            replaces="simpleimagecaptionzoo_tpu/ops/int8_attention.py:70",
            plain_ms=g["plain_ms"], bound_ms=g["bound"][0],
            bound_by=g["bound"][1], library_ms=None,
            shape="B=%d k=1 N=%d D=%d heads=%d" % (B, N_BOX, hd, heads),
            beam_shape="B=%d k=3" % B, beam_plain_ms=bm["plain_ms"],
            beam_bound_ms=bm["bound"][0])
        for r, key in (("cuda_core", "old"), ("tma", "new")):
            extra = (dict(old_route_ms=mean(g["turns"]["old"]),
                          device_old_route_ms=mean(g["dev_turns"]["old"]),
                          beam_old_route_ms=mean(bm["turns"]["old"]),
                          beam_device_old_route_ms=mean(
                              bm["dev_turns"]["old"]),
                          old_route_max_abs_err=errs["cuda_core"],
                          turns=g["turns"], device_turns=g["dev_turns"],
                          beam_turns=bm["turns"],
                          beam_device_turns=bm["dev_turns"])
                     if r == "tma" else {})
            entry("int8_attention" + ("_tma" if r == "tma" else ""), dn,
                  max_abs_err=errs[r], max_err=errs[r],
                  ms=mean(g["turns"][key]), kernel_ms=mean(g["turns"][key]),
                  device_ms=mean(g["dev_turns"][key]),
                  beam_ms=mean(bm["turns"][key]),
                  beam_device_ms=mean(bm["dev_turns"][key]), kernel_route=r,
                  **common, **extra)
        entry("int8_attention_tma_beam", dn, max_abs_err=errs["tma"],
              max_err=errs["tma"], ms=mean(bm["turns"]["new"]),
              kernel_ms=mean(bm["turns"]["new"]),
              device_ms=mean(bm["dev_turns"]["new"]),
              old_route_ms=mean(bm["turns"]["old"]),
              device_old_route_ms=mean(bm["dev_turns"]["old"]),
              plain_ms=bm["plain_ms"], bound_ms=bm["bound"][0],
              bound_by=bm["bound"][1], library_ms=None, kernel_route="tma",
              q_in_shared_memory=dtype == torch.float32,
              shape="B=%d k=3 N=%d D=%d heads=%d" % (B, N_BOX, hd, heads),
              source=common["source"], replaces=common["replaces"])
        for k, t in timed.items():
            log("K4 %s B=%d k=%d timing in turns (old, new, new, old): tma %s "
                "ms, cuda_core %s ms; device alone: tma %s, cuda_core %s ms; "
                "plain %.4f ms; bound %.4f ms (%s)"
                % (dn, B, k, ["%.4f" % v for v in t["turns"]["new"]],
                   ["%.4f" % v for v in t["turns"]["old"]],
                   ["%.4f" % v for v in t["dev_turns"]["new"]],
                   ["%.4f" % v for v in t["dev_turns"]["old"]],
                   t["plain_ms"], t["bound"][0], t["bound"][1]))

    # -- 8-13. the main paths ---------------------------------------------------
    from simpleimagecaptionzoo_tpu_torch import END_ID, PAD_ID, STA_ID
    # int8 K/V at encode (the port reads the switch there, AoA only); the
    # float paths have no int8 head, so it does not touch them
    os.environ["SICZ_TPU_INT8_KV"] = "auto"
    counters = dict(fused_head_topk=fused_head.COUNT,
                    fused_head_topk_wgmma=fused_head.COUNT_WGMMA,
                    fused_head_topk_tf32x3=fused_head.COUNT_TF32X3,
                    fused_lstm_cell=fused_lstm.COUNT,
                    fused_lstm_cell_wgmma=fused_lstm.COUNT_WGMMA,
                    fused_lstm_cell_tf32x3=fused_lstm.COUNT_TF32X3,
                    quant_matmul=quant.COUNT,
                    quant_matmul_wgmma=quant.COUNT_WGMMA,
                    quant_matmul_tf32x2=quant.COUNT_TF32X2,
                    fused_head_topk_tf32x2=fused_head.COUNT_TF32X2,
                    int8_attention=int8_attention.COUNT,
                    int8_attention_tma=int8_attention.COUNT_TMA)
    # launches per step of each counter (COUNT is every launch of K1, K2, K3
    # or K4; the _wgmma, _tf32x3 and _tf32x2 counters those of a
    # tensor-core route, _tma those of K4's "tma" route): every K1 and K2
    # launch of a float32 decode on "tf32x3", of a bf16 decode on "wgmma",
    # every K1-int8 and K3 launch of an int8 float32 decode on "tf32x2", of
    # an int8 bf16 decode on "wgmma", every K4 launch on "tma".  AoA runs
    # one cell a step and, in int8, K3 three times and K4 (AoASpatial no
    # K4); BUTD two cells, K3 three times (its two cells and att_dec) and
    # no K4; NIC one cell (K3 once in int8), plus once more at init
    nil = dict.fromkeys(counters, 0)
    kernel_counter = {"K2": "fused_lstm_cell", "K3": "quant_matmul"}

    def once(init_shapes):
        """How the counters move for the launches made once a decode, outside
        its steps (NIC's step -1 cell): K2 or K3 at ``init_shapes``."""
        out = {}
        for kn, route, _, _ in init_shapes:
            for name in (kernel_counter[kn], kernel_counter[kn] + "_" + route):
                out[name] = out.get(name, 0) + 1
        return out

    def family_paths(rows, k, beam, prm, qprm, k2, k3, k1_tag="", k4=False,
                     init_cell=False):
        """A family's four paths (float32, bf16, int8 float32, int8 bf16) at
        ``rows`` and k: (label, dtype, params, launches per step, each
        launch shape (holds.recording_shapes) -> the kernels-line entry its
        launches go to, the shapes launched once more a decode).  ``k2``
        and ``k3``: (the width of x, entry name with "{}" for the route),
        K2's on the float paths, K3's on the int8 paths; K1 at rows and k,
        its entry ``fused_head_topk_<route>`` (int8 bf16:
        ``fused_head_topk_int8_wgmma``) + ``k1_tag``; K4 (int8 only) over B
        samples at k query rows; ``init_cell``: the first width of K2 (K3)
        once more at init."""
        sfx = "_beam" if beam else ""
        out = []
        for label, dtype, route, int8 in (
                ("float32", torch.float32, "tf32x3", False),
                ("bfloat16", torch.bfloat16, "wgmma", False),
                ("int8/float32", torch.float32, "tf32x2", True),
                ("int8/bfloat16", torch.bfloat16, "wgmma", True)):
            dn = str(dtype).split(".")[1]
            k1 = ("fused_head_topk_int8_wgmma" if int8 and route == "wgmma"
                  else "fused_head_topk_" + route) + k1_tag
            kn, widths = ("K3", k3) if int8 else ("K2", k2)
            step = dict(nil, fused_head_topk=1,
                        **{"fused_head_topk_" + route: 1,
                           kernel_counter[kn]: len(widths),
                           kernel_counter[kn] + "_" + route: len(widths)})
            shapes = {("K1", route, rows, k): "%s%s/%s" % (k1, sfx, dn)}
            for w, ename in widths:
                shapes[kn, route, rows, w] = "%s%s/%s" % (ename.format(route),
                                                          sfx, dn)
            if k4 and int8:
                shapes["K4", "tma", B, k] = "int8_attention_tma%s/%s" % (sfx,
                                                                         dn)
                step.update(int8_attention=1, int8_attention_tma=1)
            out.append((label, dtype, qprm if int8 else prm, step, shapes,
                        [(kn, route, rows, widths[0][0])] if init_cell
                        else []))
        return out

    def aoa_paths(rows, k, beam):
        hd = FULL["hidden_dim"]
        e_in = FULL["embed_dim"] + hd
        return family_paths(rows, k, beam, params, qparams,
                            k2=[(e_in, "fused_lstm_cell_{}")],
                            k3=[(w, "quant_matmul_{}")
                                for w in (e_in + hd, hd, 2 * hd)], k4=True)

    def butd_paths(rows, k, beam, prm=None, qprm=None):
        return family_paths(
            rows, k, beam, prm or bparams, qprm or bq,
            k2=[(e, "fused_lstm_cell_{}_butd_" + tag)
                for tag, _, e in butd_k2_path],
            k3=[(w, "quant_matmul_{}_butd_" + tag) for tag, _, w in butd_k3])

    def nic_paths(rows, k, beam, prm=None, qprm=None):
        return family_paths(
            rows, k, beam, prm or nparams, qprm or nq, k1_tag="_nic",
            k2=[(e_nic, "fused_lstm_cell_{}_nic")],
            k3=[(e_nic + ncfg.hidden_dim, "quant_matmul_{}_nic_lstm")],
            init_cell=True)

    def aoasp_paths(rows, k, beam, prm=None, qprm=None):
        hd = acfg.hidden_dim
        return family_paths(
            rows, k, beam, prm or aparams, qprm or aq, k1_tag="_aoasp",
            k2=[(e_aoasp, "fused_lstm_cell_{}_aoasp")],
            k3=[(e_aoasp + hd, "quant_matmul_{}_aoasp_lstm"),
                (hd, "quant_matmul_{}_aoasp_q"),
                (2 * hd, "quant_matmul_{}_aoasp_aoa")])

    on_path = set()

    def credit(label, shapes, n_steps, shape_entries, init_shapes):
        """Every launch of one reading run at the shape its path expects,
        each shape once a step and those of ``init_shapes`` once more; each
        entry's ``launches`` is the sum over the main paths' reading runs
        (``launches_by_path`` per path)."""
        got = {}
        for shp in shapes:
            got[shp] = got.get(shp, 0) + 1
        require(set(got) == set(shape_entries)
                and all(v == n_steps + init_shapes.count(shp)
                        for shp, v in got.items()),
                "%s: launch shapes %s, expected each of %s once a step (%d "
                "steps), and %s once more" % (
                    label, sorted(got.items(), key=str),
                    sorted(shape_entries, key=str), n_steps, init_shapes))
        for shp, ename in shape_entries.items():
            by_path = stub_entry(kernels, ename).setdefault(
                "launches_by_path", {})
            by_path[label] = by_path.get(label, 0) + got[shp]
            kernels[ename]["launches"] = sum(by_path.values())
            on_path.add(ename)

    def feat_rows(model, visual):
        if model.config.model_type == "NIC":      # one pooled feature
            return 1
        if "img_tensors" in visual:              # from pixels: the grid
            return model.config.num_pixels
        return (visual["bu_feats"] if "bu_feats" in visual
                else visual["spatial_feats"]).shape[1]

    def alpha_tol(family, dtype):
        """How far a live step's alphas may sum from 1: AoA's are float32
        whatever the dtype; BUTD's come from a softmax in the compute
        dtype, and bf16 rounds each to within 2^-9 of itself, so their sum
        to within 2^-9 of 1 (2^-8 is held)."""
        return 2.0 ** -8 if (family.startswith("BUTD")
                             and dtype == torch.bfloat16) else 1e-3

    def check_alphas(tag, al, model, visual, n_rows, tol):
        if model.config.model_type == "NIC":
            # NIC has no attention: beam search's alphas are zeros
            require(al.shape == (B, n_rows, 1) and bool((al == 0).all()),
                    "%s alphas: shape %s, or not zero" % (tag,
                                                          tuple(al.shape)))
            return
        live = al.sum(-1) > 0
        mask = visual.get("bu_masks")
        require(al.shape == (B, n_rows, feat_rows(model, visual))
                and bool(torch.isfinite(al).all())
                and bool(((al.sum(-1) - 1).abs()[live] < tol).all())
                and bool((al[~live] == 0).all())
                and (mask is None or bool((al.masked_select(
                    (mask[:, None, :] == 0).expand_as(al)) == 0).all())),
                "%s alphas: shape %s, or not finite, or not summing to 1 "
                "within %g on live steps (off by up to %.3g), or nonzero on "
                "masked boxes" % (tag, tuple(al.shape), tol,
                                  float((al.sum(-1) - 1).abs()[live].max())))

    def drive_greedy(family, model, visual, paths, kv_int8=None,
                     model_state=None, memo=None):
        """Phases 8, 10, 12, 13 and 17: greedy decode of ``model`` on each
        path, once through the plain versions and three times through the
        kernels (launches per step, route and shape exact), then profiled.
        ``kv_int8``: None, or whether encode stores int8 K/V on the int8
        paths (AoA; else K/V in the compute dtype).  From pixels (phase
        17), ``memo`` (a TrunkMemo): the plain run comes after the kernel
        runs, on the last one's feature map."""
        ms = {} if model_state is None else model_state
        calls, kv_kinds, shapes = [], [], []
        step_core, encode = model.step_core, model.encode

        def counting_step_core(*a, **kw):
            calls.append(1)
            return step_core(*a, **kw)

        def recording_encode(*a, **kw):
            enc, st = encode(*a, **kw)
            if kv_int8 is not None:
                kv_kinds.append(enc.extras["k_q" if "k_q" in enc.extras
                                           else "k_proj"].dtype)
            return enc, st

        model.step_core = counting_step_core
        model.encode = recording_encode
        out, float_ids = {}, {}
        for label, dtype, prm, step_launches, shape_entries, init in paths:
            dn = str(dtype).split(".")[1]
            int8 = label.startswith("int8")
            tag = "%s %s" % (family, label)
            fn = steps.make_greedy_decode(model, max_len=MAX_LEN,
                                          return_alphas=True, dtype=dtype,
                                          device="cuda")
            if memo is None:
                with holds.plain_versions():
                    ref_ids, ref_al = fn(prm, ms, visual)
                torch.cuda.synchronize()
            else:
                memo.mode = "record"
            times, launches = [], None
            for _ in range(3):
                calls.clear()
                shapes.clear()
                for c in counters.values():
                    c.n = 0
                t0 = time.perf_counter()
                with holds.recording_shapes(shapes):
                    ids, al = fn(prm, ms, visual)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                n_steps = len(calls)
                launches = {kn: c.n for kn, c in counters.items()}
                want = {kn: m * n_steps + once(init).get(kn, 0)
                        for kn, m in step_launches.items()}
                require(n_steps >= 1 and launches == want,
                        "%s decode: %d steps, launches %s, expected %s"
                        % (tag, n_steps, launches, want))
            if memo is not None:
                with memo.replaying(), holds.plain_versions():
                    ref_ids, ref_al = fn(prm, ms, visual)
                torch.cuda.synchronize()
            if kv_int8 is not None:
                require(kv_kinds[-1] == (torch.int8 if int8 and kv_int8
                                         else dtype),
                        "%s decode: encode stored its K/V as %s"
                        % (tag, kv_kinds[-1]))
            require(ids.shape == (B, MAX_LEN), "%s decode shape %s"
                    % (tag, tuple(ids.shape)))
            require(int(ids.min()) >= 0
                    and int(ids.max()) < FULL["vocab_size"],
                    "%s decode ids out of range" % tag)
            if model.config.model_type == "NIC":
                # NIC has no attention: greedy returns no alphas
                require(al is None and ref_al is None,
                        "%s decode returned alphas" % tag)
            else:
                check_alphas(tag + " decode", al, model, visual, MAX_LEN,
                             alpha_tol(family, dtype))
            rows_same = float((ids == ref_ids).all(dim=1).float().mean())
            first_same = float((ids[:, 0] == ref_ids[:, 0]).float().mean())
            if label == "float32":
                require(rows_same >= 0.99, "%s decode: only %.4f of rows "
                        "equal the plain run's" % (tag, rows_same))
            else:
                require(first_same >= 0.99, "%s decode: only %.4f of first "
                        "ids equal the plain run's" % (tag, first_same))
            t_med = sorted(times)[1]
            res = dict(steps=n_steps, launches=launches,
                       launch_shapes=sorted([list(x) for x in set(shapes)],
                                            key=str),
                       rows_identical=rows_same,
                       first_ids_identical=first_same,
                       alphas_max_abs_diff=(None if al is None else float(
                           (al - ref_al).abs().max())),
                       seconds=times, captions_per_s=B / t_med)
            extra = ""
            if int8:
                # int8 is an approximation of the float decode, not a copy
                fids = float_ids[dn]
                res["first_ids_vs_float"] = float(
                    (ids[:, 0] == fids[:, 0]).float().mean())
                res["rows_vs_float"] = float((ids == fids).all(dim=1).float()
                                             .mean())
                extra = ("; against the %s float decode: first ids %.4f, "
                         "rows %.4f" % (dn, res["first_ids_vs_float"],
                                        res["rows_vs_float"]))
            credit(tag + " greedy", shapes, n_steps, shape_entries, init)
            log("decode %s: B=%d, %d steps, launches %s, shapes %s%s; rows "
                "identical to the plain run %.4f, first ids %.4f%s; %.1f "
                "captions/s (median of %s s)"
                % (tag, B, n_steps, launches, res["launch_shapes"],
                   "; K/V stored %s" % kv_kinds[-1] if kv_int8 is not None
                   else "", rows_same,
                   first_same, extra, B / t_med,
                   ["%.4f" % t for t in times]))
            res["profile"] = profile_decode(
                torch, lambda: fn(prm, ms, visual), tag)
            out[label] = res
            if not int8:
                float_ids[dn] = ids
        del model.step_core, model.encode
        return out

    def drive_beam(family, model, visual, paths, model_state=None,
                   memo=None):
        """Phases 9-13 and 17: beam-3 decode of ``model`` on each path,
        once through the plain versions, three times through the kernels
        (timed; launches per step, route and shape exact), once with
        alphas, once with every kernel call held against its plain version,
        then the end-to-end gate against the plain run, then profiled.
        From pixels (phase 17), ``memo`` (a TrunkMemo): the plain run and
        the rescoring read the last timed run's feature map."""
        ms = {} if model_state is None else model_state
        lane_steps, shapes = [], []
        step_lanes_core = model.step_lanes_core

        def counting_step_lanes_core(*a, **kw):
            lane_steps.append(1)
            return step_lanes_core(*a, **kw)

        model.step_lanes_core = counting_step_lanes_core
        out = {}
        for label, dtype, prm, step_launches, shape_entries, init in paths:
            tag = "beam %s %s" % (family, label)
            fn = steps.make_beam_decode(model, beam_size=BEAM,
                                        max_steps=MAX_LEN, dtype=dtype,
                                        device="cuda")
            if memo is None:
                with holds.plain_versions():
                    ref_ids = fn(prm, ms, visual)
                torch.cuda.synchronize()
            else:
                memo.mode = "record"
            times = []
            for _ in range(3):
                lane_steps.clear()
                shapes.clear()
                for c in counters.values():
                    c.n = 0
                t0 = time.perf_counter()
                with holds.recording_shapes(shapes):
                    ids = fn(prm, ms, visual)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                n_steps = len(lane_steps)
                launches = {kn: c.n for kn, c in counters.items()}
                want = {kn: m * n_steps + once(init).get(kn, 0)
                        for kn, m in step_launches.items()}
                require(n_steps >= 1 and launches == want,
                        "%s decode: %d steps, launches %s, expected %s"
                        % (tag, n_steps, launches, want))
            if memo is not None:
                memo.mode = "pass"
                with memo.replaying(), holds.plain_versions():
                    ref_ids = fn(prm, ms, visual)
                torch.cuda.synchronize()
            require(ids.shape == (B, MAX_LEN + 1) and ids.dtype == torch.long,
                    "%s ids %s %s" % (tag, tuple(ids.shape), ids.dtype))
            require(bool((ids[:, 0] == STA_ID).all()) and int(ids.min()) >= 0
                    and int(ids.max()) < FULL["vocab_size"],
                    "%s ids: column 0 not <sta>, or out of range" % tag)
            ended = (ids[:, 1:] == END_ID).cumsum(dim=1) > 0
            after = torch.cat([torch.zeros_like(ended[:, :1]),
                               ended[:, :-1]], 1)
            require(bool((ids[:, 1:][after] == PAD_ID).all()),
                    "%s ids: not <pad> after <end>" % tag)
            # the alphas of one more run: finite, summing to 1 on live
            # steps, 0 on masked boxes
            _, al = steps.make_beam_decode(model, beam_size=BEAM,
                                           max_steps=MAX_LEN,
                                           return_alphas=True, dtype=dtype,
                                           device="cuda")(prm, ms, visual)
            check_alphas(tag, al, model, visual, MAX_LEN,
                         alpha_tol(family, dtype))
            # one more run with every kernel call held against its plain
            # version on the same inputs, to the kernel's own tolerance
            broken = []
            with holds.held_calls(broken):
                fn(prm, ms, visual)
            torch.cuda.synchronize()
            require(not broken, "%s decode: %d kernel calls broke their "
                    "hold (first: %s)" % (tag, len(broken), broken[:1]))
            # rescore both runs' winners with the plain step in this dtype
            with (memo.replaying() if memo is not None
                  else contextlib.nullcontext()):
                margin = holds.rescored_margin(model, prm, visual, ids,
                                               ref_ids, dtype, dev, ms)
            tol = holds.beam_tol(dtype, MAX_LEN)
            passed, rows_same = holds.beam_gate(label == "float32", ids,
                                                ref_ids, margin, tol)
            first_same = float((ids[:, 1] == ref_ids[:, 1]).float().mean())
            require(passed, "%s decode: rows identical to the plain run's "
                    "%.4f (gate %.2f in float32); a row's winner scores %.4f "
                    "below the plain run's winner (tol %.4f)"
                    % (tag, rows_same, holds.ROWS_IDENTICAL,
                       -float(margin.min()), tol))
            t_med = sorted(times)[1]
            res = dict(steps=n_steps, launches=launches,
                       launch_shapes=sorted([list(x) for x in set(shapes)],
                                            key=str),
                       rows_identical=rows_same,
                       first_ids_identical=first_same,
                       rescored_min_margin=float(margin.min()),
                       rescored_rows_below=int((margin < 0).sum()),
                       rescore_tol=tol, seconds=times,
                       captions_per_s=B / t_med,
                       rows_ended=int(ended[:, -1].sum()))
            credit(tag, shapes, n_steps, shape_entries, init)
            log("%s decode: B=%d, beam %d, %d steps, launches %s, shapes "
                "%s; every kernel call of a run held against its plain "
                "version; rows identical to the plain run %.4f, first ids "
                "%.4f; rescored by the plain step, the kernel run's winner "
                "minus the plain run's: min %.4f (%s %.4f), %d rows below 0; "
                "%d rows ended; %.1f captions/s (median of %s s)"
                % (tag, B, BEAM, n_steps, launches, res["launch_shapes"],
                   rows_same, first_same, float(margin.min()),
                   "ungated, tol" if label == "float32" else "tol", tol,
                   res["rescored_rows_below"], res["rows_ended"], B / t_med,
                   ["%.4f" % t for t in times]))
            res["profile"] = profile_decode(
                torch, lambda: fn(prm, ms, visual), tag)
            out[label] = res
        del model.step_lanes_core
        return out

    log("-- phase 8 at %.1f s" % (time.time() - t_start))
    # -- 8. the main path: AoADetection greedy ---------------------------------
    visual = {
        "bu_feats": torch.relu(torch.randn(B, N_BOX, FULL["enc_dim"],
                                           generator=gen, device=dev)),
        "bu_masks": box_mask,
    }
    mk = B * BEAM
    results["decode"] = drive_greedy("AoADetection", model, visual,
                                     aoa_paths(B, 1, False), kv_int8=True)
    log("-- phase 9 at %.1f s" % (time.time() - t_start))
    # -- 9. the main path, beam: AoADetection beam 3 -----------------------------
    results["beam"] = drive_beam("AoADetection", model, visual,
                                 aoa_paths(mk, BEAM, True))
    log("-- phase 10 at %.1f s" % (time.time() - t_start))
    # -- 10. BUTDDetection, greedy and beam 3, on the four paths --------------
    bu_visual = {
        "bu_feats": torch.relu(torch.randn(B, N_BOX, bcfg.enc_dim,
                                           generator=gen, device=dev)),
        "bu_masks": box_mask,
    }
    results["butd_detection"] = dict(
        decode=drive_greedy("BUTDDetection", butd, bu_visual,
                            butd_paths(B, 1, False)),
        beam=drive_beam("BUTDDetection", butd, bu_visual,
                        butd_paths(mk, BEAM, True)))
    log("-- phase 11 at %.1f s" % (time.time() - t_start))
    # -- 11. BUTDSpatial, beam 3 in bf16 and int8 bf16 -------------------------
    sp_visual = {"spatial_feats": torch.relu(torch.randn(
        B, N_GRID, bcfg.enc_dim, generator=gen, device=dev))}
    results["butd_spatial"] = dict(beam=drive_beam(
        "BUTDSpatial", butd_sp, sp_visual,
        [p for p in butd_paths(mk, BEAM, True)
         if p[0] in ("bfloat16", "int8/bfloat16")]))
    log("-- phase 12 at %.1f s" % (time.time() - t_start))
    # -- 12. NIC, greedy and beam 3, on the four paths ------------------------
    nic_visual = {"features": torch.relu(torch.randn(
        B, ncfg.enc_dim, generator=gen, device=dev))}
    results["nic"] = dict(
        decode=drive_greedy("NIC", nic, nic_visual, nic_paths(B, 1, False)),
        beam=drive_beam("NIC", nic, nic_visual, nic_paths(mk, BEAM, True)))
    log("-- phase 13 at %.1f s" % (time.time() - t_start))
    # -- 13. AoASpatial, greedy and beam 3, on the four paths -----------------
    asp_visual = {"spatial_feats": torch.relu(torch.randn(
        B, acfg.num_pixels, acfg.enc_dim, generator=gen, device=dev))}
    results["aoa_spatial"] = dict(
        decode=drive_greedy("AoASpatial", aoasp, asp_visual,
                            aoasp_paths(B, 1, False), kv_int8=False),
        beam=drive_beam("AoASpatial", aoasp, asp_visual,
                        aoasp_paths(mk, BEAM, True)))

    log("-- phase 14 at %.1f s" % (time.time() - t_start))
    # -- 14. XE training of AoADetection, through make_xe_train_step ---------
    bf = torch.bfloat16
    results["xe"] = drive_xe(
        torch, args, dev, model, params, kernels, on_path,
        name="AoADetection", cells=[("", FULL["embed_dim"]
                                     + FULL["hidden_dim"])], lr=TRAIN_LR,
        variants=[("float32", None, False), ("float32", None, True),
                  ("bfloat16", bf, False), ("bfloat16", bf, True)],
        # scheduled sampling off: teacher forcing hoisted, the cell over
        # mean + ctx alone (phase 22's entries ..._tf)
        tf_cells=[("_tf", FULL["hidden_dim"])])

    log("-- phase 15 at %.1f s" % (time.time() - t_start))
    # -- 15. SCST of AoADetection, through make_scst_train_step --------------
    # the references' ids lie below the smaller vocabulary (phase 16's), so
    # one table serves both phases
    scst = scst_data(torch, args, dev, BENCH_VOCAB)
    results["scst_table"] = dict(keys=int(scst[0]["h1"].shape[0]),
                                 probe=scst[1])
    aoa_json = load_model_config(os.path.join(
        HERE, "Configs", "Models", "AoADetection.json"),
        vocab_size=FULL["vocab_size"])
    results["scst"] = drive_scst(
        torch, args, dev, model, params, kernels, on_path, scst,
        name="AoADetection", cells=[("", FULL["embed_dim"]
                                     + FULL["hidden_dim"])],
        lr=aoa_json.scst_lr, variants=[("float32", None), ("bfloat16", bf)])

    log("-- phase 16 at %.1f s" % (time.time() - t_start))
    # -- 16. BUTDDetection XE and SCST at examples/bench_train.py's shape ---
    bench = get_captioner(load_model_config(
        os.path.join(HERE, "Configs", "Models", "BUTDDetection.json"),
        vocab_size=BENCH_VOCAB))
    bench_params = bench.init_params(gen)
    bench_cells = [("_butd_" + tag, e) for tag, _, e in butd_k2_path]
    results["butd_train"] = dict(
        xe=drive_xe(torch, args, dev, bench, bench_params, kernels, on_path,
                    name="BUTDDetection", cells=bench_cells,
                    lr=bench.config.lr, n_timed=BENCH_STEPS,
                    variants=[("float32", None, True),
                              ("bfloat16", bf, True)]),
        scst=drive_scst(torch, args, dev, bench, bench_params, kernels,
                        on_path, scst, name="BUTDDetection",
                        cells=bench_cells, lr=bench.config.scst_lr,
                        n_timed=BENCH_STEPS,
                        variants=[("float32", None), ("bfloat16", bf)]))

    log("-- phase 17 at %.1f s" % (time.time() - t_start))
    # -- 17. captions from pixels: NIC, BUTDSpatial, AoASpatial --------------
    results["pixels"] = drive_pixels(
        torch, dev, gen, smi, flush, steps, drive_greedy, drive_beam,
        [("NIC", nic, nparams, nic_paths, (B, ncfg.enc_dim), None),
         ("BUTDSpatial", butd_sp, bparams, butd_paths,
          (B, N_GRID, bcfg.enc_dim), None),
         ("AoASpatial", aoasp, aparams, aoasp_paths,
          (B, acfg.num_pixels, acfg.enc_dim), False)])

    log("-- phase 18 at %.1f s" % (time.time() - t_start))
    # -- 18. the CLI on the card: train, scst_train, eval, sample ------------
    results["cli"] = drive_cli(
        torch, args, dev, flush, kernels, on_path,
        bare={"xe/float32": results["xe"]["float32/ss_off"]["ms_per_step"],
              "xe/bfloat16": results["xe"]["bfloat16/ss_off"]["ms_per_step"],
              "scst/float32": results["scst"]["float32"]["ms_per_step"]})

    log("-- phase 19 at %.1f s" % (time.time() - t_start))
    t19 = time.time()
    # -- 19. serving on the card: the directory captioner and the server ----
    results["serve"] = drive_serve(torch, args, dev, gen, smi, flush,
                                   kernels, on_path)

    log("-- phase 20 at %.1f s" % (time.time() - t_start))
    # -- 20. XE and SCST from pixels: BUTDSpatial, AoASpatial; NIC's SCST ---
    try:
        results["pixel_training"] = drive_pixel_training(
            torch, args, dev, gen, smi, flush, kernels, on_path, scst)
    finally:
        s1920 = time.time() - t19
        log("-- phases 19-20 took %.1f s (phase 19 %.1f)"
            % (s1920, results["serve"]["seconds"]["total"]))

    require(s1920 <= PHASES_19_20_S, "phases 19-20 took %.1f s, over their "
            "%.0f s" % (s1920, PHASES_19_20_S))

    log("-- phase 21 at %.1f s" % (time.time() - t_start))
    # -- 21. mid-epoch resume, data parallel, reference checkpoints ---------
    results["scale_out"] = drive_phase21(torch, args, dev, flush, kernels,
                                         on_path, model, params)

    log("-- phase 22 at %.1f s" % (time.time() - t_start))
    # -- 22. the JAX default mode's LSTM input hoists on K2 ------------------
    results["hoists"] = drive_hoists(
        torch, args, dev, gen, smi, flush, kernels, on_path, butd=butd,
        bparams=bparams, aoa=model, aparams=params, nic=nic, nparams=nparams,
        aoasp=aoasp, spparams=aparams)

    log("-- phase 23 at %.1f s" % (time.time() - t_start))
    # -- 23. the COCO14 dry run through the port; the mesh's model axis ----
    results["dry_run_and_model_axis"] = drive_phase23(
        torch, args, dev, smi, flush, kernels, on_path)

    log("-- phase 24 at %.1f s" % (time.time() - t_start))
    # -- 24. the synthetic-data quality gate and the two demos -------------
    results["quality_gate"] = drive_phase24(torch, args, dev, smi, flush,
                                            kernels, on_path)

    results["seconds"] = time.time() - t_start
    log("-- phases 2-24 took %.1f s" % results["seconds"])
    missing = [k for k in on_path if not kernels[k].get("launches")]
    require(not missing, "kernels not launched on the main path: %s"
            % missing)
    # the CUDA-core routes of K1, K2, K3, K1-int8 and K4 are held and timed
    # above but no decode runs them: operands TMA cannot take go there
    for k, v in kernels.items():
        v.setdefault("launches", 0)
    # every entry carries the kernels line's keys (a shape a path credited
    # before phase 22 measured it included)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    bare = {k: [key for key in keys if key not in v]
            for k, v in kernels.items() if any(key not in v for key in keys)}
    require(not bare, "kernels line entries without their keys: %s" % bare)

    results["phase_budgets"] = budgets = {
        name: dict(seconds=round(sec, 1), budget=cap,
                   share=round(sec / cap, 3))
        for name, sec, cap in (
            ("18", results["cli"]["seconds"], CLI_PHASE_S),
            ("19-20", s1920, PHASES_19_20_S),
            ("21", results["scale_out"]["seconds"], PHASE21_S),
            ("22", results["hoists"]["seconds"]["total"], HOIST_PHASE_S),
            ("23", results["dry_run_and_model_axis"]["seconds"],
             PHASE23_S),
            ("24", results["quality_gate"]["seconds"], PHASE24_S))}
    results["kernels"] = list(kernels.values())
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    # each timed phase's seconds beside its budget and the share used
    print(json.dumps({"phase_budgets": budgets}))
    print(json.dumps({"kernels": results["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--phase21-cli":
        sys.exit(cli_child(sys.argv[2:]))
    if len(sys.argv) > 1 and sys.argv[1] == "--phase21-dp":
        sys.exit(dp_child(sys.argv[2:]))
    if len(sys.argv) > 1 and sys.argv[1] == "--phase23-mp":
        sys.exit(mp_child(sys.argv[2:]))
    sys.exit(main())
