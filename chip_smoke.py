"""GPU smoke run of the PyTorch port: 2D serving, 3D sliding-window
inference, 3D 'gcr' training, 2D classic-UNet training, UNet-3+ training
and serving, the config-driven 3D pipeline (YAML configs, HDF5 volumes),
the rest of the 3D family (bf16, device_cache, ResidualUNetSE3D,
BatchNorm, UNet2D / ResidualUNet2D, remat), int8 post-training
quantization, exported artifacts, SAM-Med2D promptable serving,
data-parallel training with its checkpoint and the profiler tooling,
spatially sharded training with halo exchange, the model axis (channel
tensor parallelism, ZeRO-1, sharded checkpoints), the image formats the
JAX package reads (TIFF, GIF, BMP, JPEG: serving, DRIVE training,
DSB2018), and the JAX package's orbax checkpoints resumed.

    python3 chip_smoke.py [--phase 18|19|20|21|23|24|25|26|27|28|29|30]

Needs one CUDA card, nvcc and the checkout this file sits in; imports nothing
of JAX (nor PyYAML or h5py).  It exits non-zero, without printing a result,
when any of those is missing or any phase fails.  Every phase prints its
wall time.

1. DoubleConv kernel against its plain version: builds all of ``csrc/`` for
   sm_90a from this checkout (one nvcc per source, in parallel; the ptxas
   register, shared-memory and spill lines of every kernel are printed),
   runs ``fused_double2d`` on the 9 DoubleConv shapes of the base-64 UNet
   at 256² (N=2) plus ragged shapes, in float32 (plain version with TF32
   off, rtol = atol = 1e-4) and bfloat16 (rtol = atol = 2e-2, about two
   bf16 ulps), comparing y and z, and times kernel and cuDNN pair with CUDA
   events (median of 20 after warm-up); then the 9 shapes in bf16 at the
   other device batches the server forms (N = 1, 4, 8; the launcher's tile
   depends on N), y and z against the plain version at each, and timed at
   N=8, the served batch.  Each line gives the kernel's TFLOP/s and its
   share of the tensor-core peak (bf16 989, fp32 against TF32 495 with the
   67 TFLOP/s fp32 rate beside).
2. 2D serving: a base-64 bf16 UNet from a seeded generator is saved with
   ``save_pretrained``, loaded by ``ModelRegistry.register_unet2d(
   resolution=256, device="cuda")`` and served by ``SegmentationServer`` on
   127.0.0.1; 8 concurrent clients POST 16 synthetic PNGs (filter 0) and 8
   copies of 4 of them with every row under the Average or the Paeth
   filter (written here with zlib; decoded by the port's C unfilter), in
   the png, mask and path return modes.  Every reply must be 200 with a
   256x256 mask, each filtered copy must decode to its original's pixels
   and get its mask, the kernel must have launched 18 times per device
   batch (twice per DoubleConv: conv1, conv2), and 4 served masks must
   agree on >= 99.9% of pixels with the same model run with the plain
   DoubleConv (probabilities within 2e-2, one image at a time).  Last, one batch
   of 8 goes through the served forward against the plain path
   (probabilities within 2e-2) and is timed through both (median of 5).
   With random weights the probabilities lie near 0.48 and the masks are
   empty: the probability bounds carry the check.
3. The 3D predictor at full width: UNet3D from the model section of
   ``configs/unet3d_predict.yml`` (f_maps 64, 4 levels, 'gcr', fp32) with
   weights from a seeded generator, saved with the port's
   ``save_checkpoint``, loaded with ``load_checkpoint`` and the parameter
   bridge, and run through ``get_predictor`` and
   ``StandardPredictor._device_accumulate`` with the yml's settings (batch
   4, patch = stride 80x170x170, halo 16/32/32: 112x234x234 inputs) on a
   seeded standardized 80x340x510 volume (6 patches: a full batch and a
   padded tail).  Per batch: 14 fused GN-conv and 14 GN-statistics
   launches, and one overlap-add; the averaged map must match the same
   pipeline on the plain versions (cuDNN conv3d with TF32 off, plain GN,
   plain overlap-add) within 1e-3 x max(1, |map|), counts equal.
4. ResidualUNet3D, f_maps 32, 5 levels, 'gcr' through the same predictor
   (patch 48x96x96, halo 8/16/16: 64x128x128 inputs) on a 48x192x288
   volume: per batch 9 fused GN-conv, 18 GN-statistics and 9 GN-affine
   launches (conv3, order 'gc'); map within 2e-3 x max(1, |map|).
5. 3D serving: ``register_unet3d`` on phase 3's checkpoint at 256²
   (slices replicated to depth 8) behind ``SegmentationServer``; 4 clients
   POST 8 PNGs; all replies 200 with 256x256 masks, probabilities within
   1e-3 of the plain path at each device batch size (1, 2, 4, 8).
6. The 3D kernels against their plain versions at every shape phases 3-4
   gave them, plus ragged cases (kd 3 and 1, pre-ReLU, Ci 1/3/19/40; C 3,
   19, 300; overlapping windows with a valid = 0 tail), in fp32 and bf16:
   GN-conv within 1e-4 (fp32) / 2e-2 (bf16), GN statistics (mean and
   rsqrt(var + eps)) within 1e-4, GN affine and overlap-add bit-exact.  The
   GN affine also at the UNet3D training step's GroupNorm inputs (N=1,
   80x170x170: the x_aff recompute); the overlap-add on halo-stripped
   channel views of the network output as the predictor passes them, also
   at overlapping windows of predictor size (patch 80x170x170 at stride
   40x85x85 over 160x340x340: 27 windows), and every first call of it
   under ``torch.cuda.set_sync_debug_mode("error")`` (no copy to the card,
   no wait for it).  Kernel, plain and library ms (cuDNN conv3d,
   ``torch.var_mean``, ``torch.addcmul``) by CUDA events around each call
   (the event window: host work inside), in turns, median; the GN
   statistics', the affine's and the overlap-add's device time by
   ``torch.profiler``; each case's bound; sums over the model shapes (one
   ``[phase 6]`` line per kernel and dtype: window, device, library,
   bound, both shares), and the GN-conv's UNet3D predictor shapes against
   cuDNN fp32 (TF32 off).  Two calls of the GN statistics on the same
   inputs must give the same bits.
7. The GroupNorm backward kernels (Σg and Σg·x̂; dx = g·A + x·C + D)
   against their plain versions at every GroupNorm input shape of the two
   training models (UNet3D at 80x170x170, ResidualUNet3D at 64x128x128,
   N = 1, found by one forward with hooks) plus ragged C and C = 1, in fp32
   and bf16: the sums within 1e-5 x the number of positions and the same
   bits on two calls, dx within 1e-6 / 2e-2; kernel and plain ms by CUDA
   events, in turns, median; at the UNet3D shapes also the device time
   (``torch.profiler``), summed in one ``[phase 7]`` line per kernel and
   dtype (window, device, bound, both shares).
8. Kernel 2 at the 14 forward shapes of one UNet3D training step (N=1,
   80x170x170), held against its plain version within 1e-4 and timed
   against cuDNN conv3d (fp32, TF32 off).  Then gradients
   (dx, dscale, dbias, dw) through the autograd Functions
   ``gcr_fused_conv`` (the UNet3D's 14 shapes, kd 3 and kd 1) and
   ``GroupNorm`` (the ResidualUNet3D's shapes and ragged ones) against
   autograd through the plain composition (affine, ``F.conv3d``, ReLU;
   ``F.group_norm``), fp32 with TF32 off: within 1e-3 of each gradient's
   max |value|.  The cotangent is zeroed where either output lies within
   1e-4 x max|y| of the ReLU's kink, which neither path decides exactly.
9. Training at full width: the UNet3D and the loss, metric, optimizer,
   scheduler and settings of ``configs/unet3d_train.yml`` (f_maps 64, 4
   levels, 'gcr', BCEDice, MeanIoU, Adam 2e-4 / 1e-5, ReduceLROnPlateau;
   batch 1, patch 80x170x170, train stride 40x90x90, fp32, TF32 off) with
   weights from a seeded generator, loaded through ``pre_trained``, driven
   by ``UNetTrainer.fit()`` over a ``VolumeLoader`` of 4 patches of a
   seeded 80x260x260 volume (label: its smoothed sign) and 2 validation
   patches: 7 steps, validation and checkpoints at iterations 3 and 6.
   Per step 14 GN-conv, 14 GN-statistics, 14 GN-affine (the backward's
   recompute), 14 bwd-reduce and 13 bwd-dx launches (the image needs no
   dx); finite losses; last and best checkpoints.  The first 3 steps
   again on the plain path from the same weights: losses within 1e-5,
   1e-4, 1e-3 relative (Adam turns rounding noise into ±lr steps; see
   LOSS_TOLS) and the grad norm after step 1 within 1e-4.  A ``resume``
   from the last checkpoint takes one step at iteration 6 (Adam step 7).
   Step ms (synchronised) and peak memory of both paths.
10. ResidualUNet3D f_maps 32, 5 levels at 64x128x128 for two steps: per
   step 9 GN-conv, 18 of each GroupNorm kernel (its 'gc' conv3 runs the
   ``GroupNorm`` Function); losses and grad norm against the plain path.
11. 2D training (``UNet2DTraining``): kernel 1 at the 9 DoubleConv shapes
   at the training batch (N = 32, bf16, z written, as ``double_conv2d``'s
   forward calls it), y and z against the plain version within 2e-2,
   timed against the cuDNN pair (event window and ``torch.profiler``
   device time); ``double_conv2d``'s gradients (dx, dw1, db1, dw2, db2)
   there against autograd through the plain composition (two ``F.conv2d``
   + bias + relu in fp32, z and y rounded to the input dtype, as the
   kernel computes them), fp32 with TF32 off within 1e-3 and bf16 within
   2e-2 of each gradient's max |value|, the cotangent zeroed where the two
   y differ in sign or lie near the ReLU kink and over the 3x3 window of
   every position whose z differs in sign (at most 10% zeroed); the raw
   ``fused_double2d`` must raise on tensors that require grad.  Then ``Trainer.train()`` of the base-64 bf16 UNet (fp32
   master weights) at 256², batch 32, AdamW at 1e-3, augmentation on, on
   ``SyntheticSliceDataset(64, 256, 1)``: 10 steps, evaluation (two
   passes, batches of 32 and 8) and checkpoints at steps 5 and 10; 18
   kernel-1 launches per step and per eval batch, finite losses,
   ``checkpoint-10`` reloading equal through ``UNetModel.from_pretrained``.
   Step ms (synchronised, median of steps 3-10), slices/s and peak memory
   of the kernel path and of the plain path (``plain_path()``), and a
   ``torch.profiler`` split of 3 steps of each (kernel 1, cuDNN, the
   rest).  Last, 3 steps of each path from the same weights and batches,
   augmentation off: fp32 (TF32 off) losses within LOSS_TOLS and the
   step-1 grad norm within 1e-4; bf16 within BF16_LOSS_TOLS and 1e-2.
12. UNet-3+ (``phase_train_unet3plus``), the 2D configuration of record:
   ``Trainer.train()`` of ``UNet_3Plus`` (3 channels in, 1 out, bf16 compute,
   fp32 master weights, the hybrid F1 + MS-SSIM + IoU loss, BatchNorm) at
   512², batch 5, AdamW at 5e-3 with the other ``TrainingArguments`` at
   their defaults, augmentation off, on ``SyntheticSliceDataset(20, 512,
   3)``: 10 steps, an evaluation (10 slices) and ``checkpoint-10``
   (params and batch_stats, reloaded equal), once with remat off and once
   with ``remat_policy="save_convs"``; step ms (median of steps 3-10),
   images/s and peak memory of each, a ``torch.profiler`` split of the
   remat-off step.  Then 3 steps of each with cuDNN's deterministic
   algorithms: losses within ``U3P_REMAT_LOSS_TOLS``, running statistics
   after step 1 within 1e-6 (a second update in the recompute would show)
   and after step 3 within 1e-3.  One fp32 step (TF32 off) at 176², batch
   2, through the ``Trainer`` on the card and on the CPU from the same
   weights and batch: loss and running statistics within 1e-5; the same
   batch's forward and backward in float64 on both: grad norm within 1e-4
   (fp32 cannot resolve it there, see ``U3P_CPU_NORM_TOL``).
   ``UNet_3Plus_DeepSup`` and ``UNet_3Plus_DeepSup_CGM``
   3 steps each at 512² (CGM twice from one seed: the same losses).
   ``register_unet2d`` serves checkpoint-10 and the CGM bundle at 512²; 8
   requests each, every mask equal to the threshold of the registered
   copy's forward.  The path launches none of the seven kernels.
13. Config-driven training from HDF5 (``phase_config_train``): a seeded
   80x350x350 training volume and an 80x170x340 validation volume, each
   labelled by its smoothed raw above the 25th percentile (every train
   window above FilterSliceBuilder's 0.6), written chunked + gzip with the
   port's HDF5 codec; ``cli/train3d.py --config configs/unet3d_train.yml``
   with overrides only for the file paths, ``trainer.checkpoint_dir``,
   ``max_num_iterations`` 10, ``validate_after_iters`` and
   ``log_after_iters`` 3 (model, patch, stride and the whole transformer
   pipeline, ElasticDeformation included, as the yml has them): 11 steps
   (the seeded ElasticDeformation fires first at sample 10), each with 14
   GN-conv, 14 GN-statistics, 14 GN-affine, 14 bwd-reduce and
   13 bwd-dx launches; last and best checkpoints and the copied config.
   Prints the device step (median, synchronised) beside phase 9's
   in-memory step, the time the trainer waited in each ``next()`` of its
   train loader, the HDF5 reads (time, MiB) and the host ms per sample of
   each transform of the yml's pipelines on this machine's CPU (one patch;
   a transform with a probability timed firing).
14. Config-driven prediction to HDF5 (``phase_config_predict``): phase 3's
   seeded 80x340x510 volume written as HDF5; ``cli/predict3d.py --config
   configs/unet3d_predict.yml`` with overrides only for ``model_path``
   (phase 13's best checkpoint), ``output_dir`` and the file path: per
   batch 14 GN-conv and 14 GN-statistics launches, one overlap-add per
   batch.  ``predict_volume_predictions.h5`` read back with the port's
   reader must equal, bit for bit, the in-memory
   ``StandardPredictor._device_accumulate`` map of the same volume and
   weights (``standardized_patch_batches``) divided as ``_save_results``
   divides, and lie within 1e-3 of the plain path.  Prints the whole
   ``predict3d`` wall time and the HDF5 write time.
15. bf16 3D (``phase_train_bf16``): (a) phase 9's configuration with
   ``model.dtype: bfloat16`` (fp32 master weights), (b) bench.py's
   ``unet3d_fmaps32_64x128x128`` (UNet3D f_maps 32, 'gcr', bf16, batch 2,
   x = ``RandomState(0).rand``, y = x > 0.5, BCEDice, Adam 1e-3) and (c)
   its ``residual_unet3d_fmaps32_64x128x128``, each through UNetTrainer on
   the kernel path (5, 5 and 2 steps) and the plain path (3, 3 and 2):
   losses within ``BF16_LOSS_TOLS`` and the step-1 grad norm within 1e-2;
   launches per step asserted (the first SingleConv reads the float32
   image, so it runs the GroupNorm module and cuDNN; the other 13 kernel 2
   in bf16), every bf16 count of kernels 2 and 3a-3d above 0; step ms
   (median of steps 3+), patches/s, peak memory beside phase 9's fp32
   step.  One bf16 ``StandardPredictor`` batch of phase 3's configuration
   (its seeded weights): the map within 3e-2 x max(1, |map|) of the plain
   bf16 path and 1e-1 of the fp32 map, one overlap-add.  Kernel 2 in bf16
   at (a)'s 13 fused shapes against its plain version (2e-2), timed in
   turns with it and cuDNN's bf16 conv3d, and its device time by
   ``torch.profiler``; the bound at the bf16 peak.
16. ``device_cache`` (``phase_device_cache``): bench.py's
   ``unet3d_e2e_train_device_cache`` configuration (a 128x256x256
   ``RandomState(0).rand`` volume, label > 0.6, gzip HDF5 written by the
   port; Standardize + RandomFlip; UNet3D f_maps 32, fp32, batch 2, patch
   = stride = 64x128x128) through ``create_trainer(...).fit()``: one warm
   epoch, then 3 timed (12 steps), with ``device_cache: true``
   (``is_device_cached`` asserted) and with the host loader; ms a step,
   patches/s, the loader wait per batch, the cache's bytes on the card;
   then ``configs/unet3d_train.yml`` with ``device_cache: true`` must come
   back as a ``VolumeLoader`` with the fallback warning.
17. The rest of the family and remat (``phase_family_and_remat``):
   ResidualUNetSE3D (f_maps 32, 5 levels), UNet3D 'bcr' (f_maps 32; no
   kernel on its path), both at 64x128x128, batch 2, and UNet2D /
   ResidualUNet2D (f_maps 64, 'gcr', batch 8 at 256²): 3 steps each on the
   kernel path and the plain path, losses within ``LOSS_TOLS``, launches
   per step asserted; the 'bcr' step card vs CPU at 32x64x64 (loss and
   running statistics within 1e-5); phase 9's configuration under remat
   ('save_convs_norms', None) and off, 3 steps each with deterministic
   cuDNN: every loss and parameter equal to the bit, peak memory of each,
   launches per policy (None runs kernel 2 and 3a twice a step).
18. int8 post-training quantization (``phase_int8``; ``--phase 18`` runs the
   kernel build and this phase alone): (b) bench.py's int8 row
   (``bench_int8_infer``: UNet3D f_maps 32, 'gcr', bf16, batch 2 at
   64x128x128, ``RandomState(0).rand``, calibrated on that batch): the
   float forward (kernel 2) and the int8 forward, each the best of 5
   CUDA-event blocks of 3 forwards, in turns; 14 ``int8_conv`` and 14
   ``int8_quantize`` launches a forward and the output equal (within
   1e-3 of max |y|; measured equal) to the same forward with
   ``int8_conv_reference`` in place of the kernel. (c) ``cli/predict3d.py`` on a copy of
   ``configs/unet3d_predict.yml`` with ``quantize: int8`` uncommented,
   beside the yml as it is, phase 3's seeded weights and volume as gzip
   HDF5: batch 0 calibrates (no int8 launch), batch 1 runs 14
   ``int8_conv``, 14 GN-statistics and 14 GN-affine launches and no
   kernel 2; ms a batch of both runs, the int8 map's gap to the float map.
   (d) ``tests/test_int8_fidelity.py``'s recipe on the card: three seeded
   24x48x48 blob volumes (14 blobs, noise 0.2) written with the port's
   HDF5 codec, UNet3D f_maps 16, 2 levels, trained 60 iterations by
   ``create_trainer(...).fit()``, the held-out volume predicted float and
   int8 (``calib_batches: 2``): float dice > 0.5, |Δdice| < 0.05, voxel
   agreement > 0.97. (e) ``register_unet2d(quantize="int8",
   calib_batches=1)`` on phase 2's bundle beside the float model; one
   dispatched batch of 8 calibrates (no int8 launch), then 8 clients POST
   32 PNGs to each model: p50 / p99 from the clients' clocks, a device
   batch of 8 through dispatch + fetch, 18 ``int8_conv`` launches a batch;
   the served int8 masks equal to the plain int8 forward's on >= 99.9% of
   pixels and to the float masks on >= 98% (with random weights the masks
   at 0.5 are empty, so the agreement split at the float probabilities'
   median is printed beside). Every leg asserts one ``int8_quantize``
   launch per ``int8_conv`` launch. (a) both launches of ``int8_conv``
   against their plain versions at every int8 conv shape (b)-(e) gave it,
   plus ``INT8_RAGGED`` and ``INT8_EDGE`` (the halo loop's tile edges):
   ``int8_quantize``'s int8 values equal to ``_act_quant``'s, the int32
   sums and the outputs equal to ``int8_conv_reference``'s, to the bit
   (the plain version at N = 1 where x holds over 2^28 elements); the
   call's event window and ``torch.profiler`` device time (the quantize
   pass and the conv timed by kernel name and summed), the quantize pass
   apart, the plain version's ms, cuDNN's float conv at the same shape
   (labelled as the float conv: PyTorch has no one-call int8 conv on
   CUDA), the bound (ops at the 1979 TOP/s int8 peak or bytes at 3.35
   TB/s) and its share; summed per configuration.
19. Export (``phase_export``; ``--phase 19`` runs it alone): (a) phase 2's
   bundle through ``export_bundle(resolution=(256, 256), device="cuda")``
   with the symbolic batch, ``torch.export.save``d and loaded again with
   ``load_exported`` in this process; the graph must call kernel 1's
   custom op (``tpuseg::fused_double2d_y``); at batches 1, 2, 4 and 8 the
   artifact's probabilities must equal the live ``register_unet2d``
   forward's to the bit, with 18 kernel-1 launches per batch inside the
   artifact; then ``register_exported`` beside ``register_unet2d`` behind
   one server, 8 clients x 4 PNGs to each: 18 launches per served batch,
   masks equal to ``register_unet2d``'s for the same PNGs; export and load
   seconds, the artifact's bytes, p50 / p99 (server latency of the
   replies) and a device batch of 8 (dispatch + fetch, median of 5) beside
   ``register_unet2d``'s.  (b) phase 3's UNet3D and phase 4's
   ResidualUNet3D as ``UNet3DForMedicalSegmentation`` bundles from seeded
   generators, exported at their padded predictor patch (112x234x234,
   64x128x128), one batch of 4 through each artifact against the eager
   forward (within 1e-3 / 2e-3 x max(1, |y|), TF32 off; same bits
   printed), launches per batch as phases 3 and 4 assert them (14 / 14 / 0
   and 9 / 18 / 9 of kernels 2 / 3a / 3b).
20. SAM-Med2D (``phase_sam``; ``--phase 20`` runs it alone): ``SAMMed2D``
   at the JAX package's defaults (img 256, embed 384, depth 6, heads 6,
   prompt 256) from a seeded generator, ``save_sam``, ``register_sam`` on
   the card; 8 clients x 4 requests over phase 2's scans, mixing point
   prompts (1-8 points, some background), boxes, and points with a box, in
   each image's own pixels; every device batch the engine formed must
   equal the eager forward of a second ``load_sam`` at the same batch (the
   uint8 masks, to the bit), every reply its request's batch-1 forward on
   >= 99.9% of pixels, and the 400 replies of a request with no prompt and
   one with 9 points.  The low-res logits and IoU predictions of the
   largest boxed batch, card vs CPU (fp32, TF32 off), single and
   multimask, within 1e-4 x max(1, max |CPU|).  The parameter count, the
   encoder's forward at batch 1 and 8 (best of 5 blocks of 3, CUDA events),
   a served batch of 8 (dispatch + fetch, median of 5) and p50 / p99.
21. The rest of the config-driven 3D pipeline (``phase_pipeline_rest``;
   ``--phase 21`` runs the kernel build, phases 13, 14 and this one): (a)
   ``cli/predict3d.py`` on ``configs/unet3d_predict.yml`` with phase 13's
   checkpoint and phase 14's volume, overriding only ``loaders.dataset:
   LazyHDF5Dataset`` and ``predictor.name: LazyPredictor``, three times:
   the first run appends ``raw_padded_16x32x32`` to the volume, the second
   reads it, the third saves ``segmentation`` alone (equal to the argmax of
   the map); each map within ``LAZY_MAP_TOL`` of phase 14's, 14 launches of
   kernels 2 and 3a a batch and no overlap-add (the patches are summed on
   the host); the wall time beside phase 14's, the 27-slice normalization
   and the HDF5 seconds, and ``hd95`` / ``dc`` of the map cut at its median
   against the volume's labels with their host ms.  (b) 16 seeded 8-bit
   grey PNGs at 256² in DSB's ``images/`` layout through
   ``cli/predict3d.py`` with ``DSB2018Dataset`` and ``DSB2018Predictor``
   and phase 17's UNet2D (f_maps 64, 'gcr', fp32; in 2D the GroupNorm
   module runs kernels 3a and 3b, 14 each a batch, and cuDNN the convs):
   every image's ``predictions`` within phase 3's limit of the plain path,
   its ``segmentation`` equal to ``label(p > 0.5)``; images/s.  (c)
   ``cli/train3d.py`` on ``configs/unet3d_train.yml`` and phase 13's
   volumes for 3 steps and one validation with ``optimizer: NAdam`` and
   ``eval_metric: BoundaryAdaptedRandError``: finite losses, phase 13's
   launches a step, every score equal to the CPU metric on the fetched
   output; then each of the nine steppable new optimizers, 3 updates of
   phase 9's UNet3D parameters with seeded gradients on the card against
   the CPU (within ``OPT_TOL`` of each tensor's max |p|; step ms by CUDA
   events), and LBFGS's ``TypeError`` at step 1.
22. Prints the card's name and power limit, the kernels' JSON line (launches
   from the main-path runs, each run's counts zeroed just before it, and
   for the 3D kernels their launches on each path of phases 13-17 and 21
   under ``launches_by_path``; ms, plain, library and bound ms summed over the
   model shapes: the 9 UNet DoubleConvs at N=2 in bf16, the 3D kernels'
   fp32 model shapes, and a ``gcr_conv3d_bf16`` row at phase 15's bf16
   shapes; device ms where phases 6-7 measured it, else null; kernel 1
   also its launches by path, serving and training, and under ``train``
   its numbers at the training batch; ``int8_conv`` with its launches by
   path over (b)-(e) and its times over (b)'s shapes; kernels 1, 2, 3a and
   3b with their launches inside phase 19's artifacts under
   ``export_2d`` / ``export_3d``; the data-parallel paths of phase 23
   under ``dp_*``), and last ``{"ok": true, "device": {...}}``.
23. Data parallel (``phase_data_parallel``; runs after phase 21, and
   ``--phase 23`` runs it alone), TF32 off as the CLIs pin it: (a) a world
   of 1 over NCCL (``parallel.distributed.initialize``): phase 9's
   UNetTrainer and phase 11's Trainer (base-64 UNet, bf16, batch 32) for 3
   steps with ``mesh=make_mesh()`` (DDP) against the same runs without a
   mesh, cuDNN deterministic: losses and the step-1 grad norm within phase
   9's limits (equal to the bit predicted, and printed; deterministic
   algorithms in torch too), phase 9's and 11's launches a step, the step
   ms of both; (c) ``train/dist_ckpt.py``: on an
   epoch of 2 patches in order, 2 steps, ``DistCheckpointer.save`` of
   ``checkpoint_state()``, a trainer with ``resume=`` the directory whose
   step equals the uninterrupted run's step 3 to the bit (loss,
   parameters, statistics); (d) ``train/profiling.py``: ``trace`` of a DDP
   step holds kernel 2's conv core and kernels 3a-3d (both
   ``gn_partial_kernel`` instantiations) and the ``ProfiledSection``,
   ``StepTimer`` (CUDA events) and ``device_memory_summary`` give finite
   numbers; (b) two processes of this script (``--dp-worker``) on the one
   card over gloo (NCCL refuses two ranks on one device), each with half
   of a global batch, against this process holding all of it: phase 9's
   UNet3D with ``DiceLoss`` (global batch 2) and UNet-3+ at 256², fp32,
   ``segmentation_loss`` (global batch 8): the ranks' mean losses of 3
   steps and the step-1 grad norm within phase 9's limits, the UNet-3+'s
   running statistics after step 1 within 1e-5 (after step 3 printed), the
   3D kernels' launches twice the one process's.
24. Spatially sharded training (``phase_spatial``; runs after phase 23,
   and ``--phase 24`` runs it alone), TF32 off: the UNet3D of
   configs/unet3d_train.yml at full width on one 1x80x176x170 volume (the
   yml's 170 rows of H do not split over 2 ranks with a halo of 16 under
   cross-shard statistics: ``SPATIAL_VOLUME``), split on H, halo 16.
   (a) kernels 3a and 3d with the interior window at every GroupNorm input
   of the 2-rank slab (1x80x120x170 at the input), fp32 and bf16, against
   their windowed plain versions within phase 6's and phase 7's limits,
   3a the same bits on two calls; the event window and device time of the
   windowed launch beside the whole-slab launch, the plain version,
   ``torch.var_mean`` of the window's view (3a) and the bound, the bytes
   of the rows each reads and writes. (b) ``spatial_sharded_apply``,
   per-slab and cross-shard statistics, in a world of 1 over NCCL (per
   slab: equal to the forward of the reflect-padded volume, cropped;
   cross-shard: kernels against plain versions; both within phase 3's map
   limit) and in two ``--spatial-worker`` ranks on the card over gloo:
   cross-shard at a halo of 48, which covers the 4-level model's
   receptive field (``SPATIAL_EXACT_HALO``), equal to the world of 1
   within phase 3's limit, the mesh width's invariance; at halo 16, per
   slab and cross-shard, the gap printed, near the slabs' edge and
   farther. (c) 3 steps of ``make_spatial_train_step`` (cross-shard, BCE
   with logits, the yml's Adam): at halo 48 the 2 ranks' mean losses and
   step-1 grad norm against the world of 1 within phase 9's limits; the
   step ms in the world of 1 at halo 16 beside the same model stepping on
   the unpadded volume and phase 9's step;
   ``cli/train3d.py`` with ``--parallel.spatial_halo 16
   --parallel.spatial_cross_shard_norm true`` on the yml's loss,
   transforms and Adam for 3 steps and a validation, in both worlds
   (a square 80x176x176 patch: ``SPATIAL_TRAIN_VOLUME``): finite, the same
   losses on both ranks, only rank 0 writes. (d) kernels 2 and 3a-3d
   launch 14/14/14/14/13 times a step on every rank of every path
   (asserted), the windowed 3a and 3d instantiations show in a profiled
   step, and the kernels line counts the paths under ``spatial_*``.
25. The model axis (``phase_model_axis``; runs after phase 24, and
   ``--phase 25`` runs it alone), TF32 off, every rank a ``--mp-worker``
   process sharing the one card over gloo: (e) kernel 1's single-conv
   launch (``fused_conv2d_relu``) against its plain version at the 18
   convs of the 2D TP step (bf16, N=32, Co/2) and beside cuDNN's conv2d,
   and kernel 2 at the UNet3D training shapes with Co/2 (fp32) beside its
   plain version and cuDNN's conv3d, with the bounds; (a) phase 9's UNet3D
   at full width with ``tensor_parallel`` on a model axis of 2, 3 steps,
   against the world of 1 on the same weights and batches (phase 9's
   limits; the step-1 grad norm the whole model's), launches
   14/14/14/14/13 a step on each rank asserted, step ms, per-rank peak,
   the bytes the all-gathers return and the all-reduces carry; (b) phase
   11's base-64 bf16 UNet at 256², batch 32, the same way (phase 11's bf16
   limits), 18 single-conv launches a step and no DoubleConv launch
   asserted; (c) phase 9's UNet3D on a data axis of 2 (global batch 2),
   DDP then ``zero1``, deterministic algorithms: the parameters after 3
   steps equal to the bit, the moment bytes a rank halved; (d) four ranks
   on a (2, 2) mesh with both on an epoch of 4 patches: 2 steps, the
   sharded ``DistCheckpointer`` save, a resumed step 3 equal to the
   uninterrupted one to the bit.  The kernels line gains
   ``conv2d_relu`` (kernel 1's single-conv entry) and kernel 2's ``tp``
   times, and counts the paths under ``tp_3d``, ``zero1_3d`` and
   ``tp_zero1_resume``.
26. File formats (``phase_read_formats``; runs after phase 25, and
   ``--phase 26`` runs it alone), TF32 off: (a) every HDF5 fixture of
   ``tests/fixtures/h5_latest`` (superblocks 0, 2 and 3, every layout and
   chunk index, LZF, Fletcher-32, scale-offset, bool, float16, link groups,
   soft links) and every PNG of ``tests/fixtures/png_extra`` read by the
   port, each dataset's and image's shape, dtype and SHA-256 and each
   group's keys() against ``manifest.json``, which h5py, imageio and PIL
   wrote (this machine has none of them); (b) ``cli/predict3d.py`` on
   ``configs/unet3d_predict.yml`` (StandardHDF5Dataset, a seeded
   checkpoint) over the libver='latest' (80, 340, 340) uint8 phantom
   (shuffle + gzip under a version-2 B-tree chunk index; one batch of 4)
   and over its copy written by the port's superblock-0 writer: the maps
   equal to the bit, 14/14 kernel-2 and 3a launches a batch and one
   overlap-add asserted, the whole-volume read of each file timed; (c)
   LazyHDF5Dataset + LazyPredictor twice on a copy of the latest file: the
   first appends ``raw_padded_16x32x32`` with "r+" (the root's object
   header rewritten, the superblock's root address, end of file and
   checksum patched), the second reads it; both maps within phase 21's
   Lazy limit of (b)'s, the appended structure read back; (d)
   DSB2018Predictor over the 1-, 3- and 4-channel PNG directories
   (palette, sub-byte grey, 16-bit colour, interlaced), a seeded UNet2D
   each, GroupNorm launches asserted.  The kernels line counts the paths
   under ``latest_predict3d``, ``latest_v0_predict3d``, ``latest_lazy`` and
   ``dsb_png_extra``.
27. TIFF, GIF and BMP (``phase_image_formats``; runs after phase 26, and
   ``--phase 27`` runs it alone), TF32 off: (a) every fixture of
   ``tests/fixtures/image_formats`` (TIFF: both byte orders, BigTIFF,
   strips, tiles, planar, LZW, deflate, PackBits, predictor 2, MinIsWhite,
   palette, 1-16-bit grey, float, 16-bit colour, associated alpha,
   orientation; GIF: global and local tables, interlace, offset frames,
   transparency, every LZW code size, full tables; BMP: core, INFO, V4 and
   V5 headers, 1-32 bits, bit fields, RLE8 and RLE4, top-down) read by
   ``image.read`` and ``image.imread`` equal to ``manifest.json`` (PIL's
   and imageio's arrays); (b) phase 2's base-64 bf16 UNet at 256² and its
   3-channel twin, ``max_batch`` 8, behind one ``SegmentationServer``: 8
   clients POST DRIVE-sized (565x584) TIFFs (uncompressed, LZW + predictor
   2, deflate + predictor 2, PackBits, 16-bit grey), the interlaced GIF
   manual and FOV masks and BMPs (24-bit, 8-bit palette, RLE8) to both,
   each beside a PNG of the same pixels: every reply 200, each mask equal
   to its twin's, 18 kernel-1 launches a device batch; decode ms per format
   beside its PNG twin's, p50 / p99; (c) a DRIVE layout of 20 TIFF images
   and GIF manuals: the 13 / 4 / 3 split, every item at 512² equal to a PNG
   copy's, ``cli/train2d.py --dataset DRIVE`` with the base-64 bf16 UNet
   at 512², batch 4, 3 steps and its evaluation, kernel path and plain
   path (18 launches a step and an eval batch; losses within
   ``BF16_LOSS_TOLS``); (d) DSB2018Predictor over the 1- and 3-channel
   TIFF, GIF and BMP directories, a seeded UNet2D 'gcr' each, GroupNorm
   launches asserted, maps within phase 21's limit of the plain path.  The
   kernels line counts the paths under ``formats_serve``, ``drive_train``
   and ``dsb_formats``.
28. JPEG (``phase_jpeg``; runs after phase 27, and ``--phase 28`` runs it
   alone), TF32 off, the host C of ``csrc/jpeg_decode.c`` built at the
   first decode: (a) every JPEG fixture of ``tests/fixtures/image_formats``
   (grey, YCbCr and RGB; 4:4:4, 4:2:2, 4:2:0; baseline, optimized,
   progressive, multi-scan, SOF1; restart markers; qualities 1-100; sizes
   1x1 to 37x53; EXIF Orientation 6) read by ``image.read`` and
   ``image.imread`` equal to ``manifest.json`` (PIL's and imageio's
   arrays); (b) phase 27's two UNets behind one ``SegmentationServer``: 8
   clients POST the DRIVE-sized JPEGs (baseline 4:2:0 q75, 4:4:4 q95, 4:2:2
   progressive, optimized, restart markers, grey) to both, each beside a
   PNG of the same decoded pixels: every reply 200, each mask equal to its
   twin's, 18 kernel-1 launches a device batch; decode ms per variant
   beside its PNG twin's, p50 / p99; (c) a DRIVE layout of 20 JPEG images
   and grey JPEG manuals through ``cli/train2d.py`` as in phase 27 (c)
   (every item equal to a PNG copy's, losses within ``BF16_LOSS_TOLS`` of
   the plain path, 18 launches a step and an eval batch); (d)
   DSB2018Predictor over the grey and colour JPEG directories, GroupNorm
   launches asserted, maps within phase 21's limit of the plain path.  The
   kernels line counts the paths under ``jpeg_serve``, ``jpeg_drive_train``
   and ``dsb_jpeg``.
29. Orbax (``phase_orbax``; runs after phase 28, and ``--phase 29`` runs it
   alone), TF32 off, the host C of ``csrc/zstd_decompress.c`` built at the
   first decode: (a) every zstd frame, OCDBT probe, zarr array and orbax
   checkpoint of ``tests/fixtures/orbax`` read by the port against
   ``manifest.json`` (tensorstore's reads and the JAX package's
   ``OrbaxCheckpointer.restore()``; this machine has neither); the
   decoder's MB/s of output over the TP checkpoint's chunk frames back to
   back, each checkpoint's read ms, and the read of the full-width
   checkpoint (configs/unet3d_train.yml's UNet3D with its Adam moments)
   estimated from them; (b) the JAX trainer's own checkpoints of a
   tensor-parallel run on a (2, 4) mesh and a ZeRO-1 run over 8 data
   devices (UNet3D f_maps 8, 2 levels) resumed by ``cli/train3d.py`` in a
   world of 1: the restored parameters, Adam moments, step and counters
   equal to the manifest, then 3 steps on the committed volumes on the
   kernel path and the plain path (phase 9's limits), the logged losses
   within ``ORBAX_JAX_LOSS_TOL`` of the JAX package's own resume, kernels
   2 and 3a-3d launched 6/6/6/6/5 a step (asserted); (c) two gloo ranks
   on the card (``--mp-worker``) resume the TP checkpoint with
   ``tensor_parallel`` on a model axis of 2 and with ``zero1`` on a data
   axis of 2: every rank's parameter and moment blocks the slice of (b)'s
   whole arrays, to the bit.  The kernels line counts the path under
   ``orbax_resume``.
30. The HDF5 files of ROADMAP item 20 (``phase_item20_files``; runs after
   phase 29, and ``--phase 30`` runs it alone), TF32 off, the host C of
   ``csrc/szip_decompress.c`` and ``csrc/nbit_decompress.c`` built at the
   first decode: (a) every file of ``tests/fixtures/h5_item20`` (external
   links relative, absolute, to groups and chained; virtual datasets to
   "." with strided, blocked and overlapping mappings; szip and n-bit
   chunks; external raw storage in two segments; committed datatypes)
   read by the port against ``manifest.json``, which h5py wrote; (b)
   ``cli/predict3d.py`` on ``configs/unet3d_predict.yml`` (phase 26 (b)'s
   seeded checkpoint) over the (80, 340, 340) phantom as a VDS over two
   gzip halves in two files, through an external link to
   ``h5_latest/phantom_latest.h5``, with szip (NN, 8 pixels a block) and as
   12-bit n-bit samples (the phantom x 16 in a uint16 of precision 12 at
   bit 4, then deflate): each map equal to the bit to that of a v0 copy of
   the same values that the port's writer makes, 14/14 kernel-2 and 3a
   launches a batch and one overlap-add asserted, each whole-volume read
   timed (best of 5); (c) LazyHDF5Dataset + LazyPredictor twice on a copy
   of the VDS file and its sources: the first appends
   ``raw_padded_16x32x32`` with "r+", the second reads it; both maps within
   phase 21's Lazy limit of (b)'s, the VDS read back after the append;
   (d) the szip decoder's MB/s of output over the phantom's chunks on the
   host CPU.  The kernels line counts the paths under ``item20_predict3d``
   and ``item20_lazy``.
"""

from __future__ import annotations

import base64
import contextlib
import gc
import http.client
import json
import math
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FP32_TOL = 1e-4
BF16_TOL = 2e-2
PROB_TOL = 2e-2
MASK_AGREEMENT = 0.999
REPEATS = 20
SEED = 0  # inputs and weights are random, made from this seed
SERVED_BATCH = 8
SERVED_SIZES = (1, 2, 4, 8)  # device batches the engine forms (pow-2 pad)
# published H100 SXM peaks (dense): bf16 and TF32 tensor cores, fp32 on the
# CUDA cores, HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_FP32 = 67e12
HBM_BYTES_PER_S = 3.35e12

# (N, H, W, Ci, C1, Co): the base-64 UNet's DoubleConvs at 256², then ragged
DC_SHAPES = [
    ("DC0", (2, 256, 256, 1, 64, 64)),
    ("DC1", (2, 128, 128, 64, 128, 128)),
    ("DC2", (2, 64, 64, 128, 256, 256)),
    ("DC3", (2, 32, 32, 256, 512, 512)),
    ("DC4", (2, 16, 16, 512, 1024, 1024)),
    ("DC5", (2, 32, 32, 1024, 512, 512)),
    ("DC6", (2, 64, 64, 512, 256, 256)),
    ("DC7", (2, 128, 128, 256, 128, 128)),
    ("DC8", (2, 256, 256, 128, 64, 64)),
]
RAGGED_SHAPES = [
    ("ragged_a", (2, 17, 33, 3, 20, 70)),
    ("ragged_b", (2, 33, 17, 1, 40, 100)),
    ("ragged_c", (1, 17, 17, 5, 33, 129)),
    ("ragged_d", (3, 9, 31, 19, 7, 65)),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def _import_port():
    """Import the port from this checkout, and nowhere else."""
    sys.path.insert(0, ROOT)
    import mdeical_image_segmentation_tpu_torch as port

    where = os.path.dirname(os.path.abspath(port.__file__))
    if os.path.dirname(where) != ROOT:
        raise RuntimeError(f"the port was imported from {where}, not from "
                           f"the checkout at {ROOT}")
    return port


def _inputs(shape, dtype, gen):
    import torch

    n, h, w, ci, c1, co = shape
    x = torch.rand((n, h, w, ci), device="cuda", generator=gen)
    w1 = torch.randn((3, 3, ci, c1), device="cuda", generator=gen) / (9 * ci) ** 0.5
    b1 = 0.1 * torch.randn((c1,), device="cuda", generator=gen)
    w2 = torch.randn((3, 3, c1, co), device="cuda", generator=gen) / (9 * c1) ** 0.5
    b2 = 0.1 * torch.randn((co,), device="cuda", generator=gen)
    return [t.to(dtype) for t in (x, w1, b1, w2, b2)]


def _median_ms(fn, repeats: int = REPEATS) -> float:
    import torch

    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(repeats)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(repeats)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def _peak(dtype):
    """Published dense tensor-core rate for a conv in ``dtype`` (fp32 runs
    on the TF32 units as 3xTF32; the fp32 CUDA-core rate is named beside)."""
    import torch

    return PEAK_BF16 if dtype == torch.bfloat16 else PEAK_TF32


def _bound_ms(flop: float, nbytes: float, peak: float):
    """(least ms the card could take, "operations" or "bytes")."""
    t_op, t_b = flop / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_op, "operations") if t_op >= t_b else (t_b, "bytes")


def _rate(flop: float, ms: float, dtype) -> str:
    import torch

    tf = flop / ms / 1e9
    if dtype == torch.bfloat16:
        return f"{tf:8.1f} TFLOP/s {100 * tf * 1e12 / PEAK_BF16:5.1f}% of 989"
    return (f"{tf:8.1f} TFLOP/s {100 * tf * 1e12 / PEAK_TF32:5.1f}% of 495 "
            f"(TF32; {100 * tf * 1e12 / PEAK_FP32:5.1f}% of 67 fp32)")


def _dc_flop_bytes(shape, itemsize: int, with_z: bool = False):
    """FLOP and bytes (x, weights, biases read once, y and, with_z, z
    written once) of one DoubleConvolution."""
    n, h, w, ci, c1, co = shape
    flop = 2.0 * 9 * n * h * w * (ci * c1 + c1 * co)
    nbytes = itemsize * (n * h * w * (ci + co + (c1 if with_z else 0))
                         + 9 * (ci * c1 + c1 * co) + c1 + co)
    return flop, nbytes


def _gcr_flop_bytes(shape, co: int, kd: int, itemsize: int):
    """FLOP and bytes (x and the kernel read once, y written once, a and b
    in fp32) of one fused GN-conv3d."""
    ci = shape[-1]
    positions = 1
    for d in shape[:-1]:
        positions *= d
    flop = 2.0 * kd * 9 * ci * co * positions
    nbytes = (itemsize * (positions * (ci + co) + kd * 9 * ci * co)
              + 8 * shape[0] * ci)
    return flop, nbytes


def _log_ptxas(build_log: str) -> None:
    """Registers, shared memory and spills of every kernel in the build log,
    under its name (the conv core's instantiations shortened to dtype, tile
    (rows or positions / channels / warp rows) and prologue)."""
    name = "?"
    for line in build_log.splitlines():
        if "entry function" in line:
            name = line.split("'")[1] if "'" in line else line
            m = re.search(r"(conv_\w+?_kernel)I(f|13__nv_bfloat16)\w*?Li(\d+)E"
                          r"Li(\d+)ELi(\d+)E\w*?Lb([01])", name)
            if m:
                name = (f"{m[1]}<{'fp32' if m[2] == 'f' else 'bf16'}, tile "
                        f"{m[3]}/{m[4]}/{m[5]}, affine {m[6]}>")
            m = re.search(r"int8_conv_wgmma_kernelILi(\d+)ELi(\d+)ELi(\d+)E",
                          name)
            if m:
                name = (f"int8_conv_wgmma_kernel<BN {m[1]}, warpgroups "
                        f"{m[2]}, m64 tiles {m[3]}>")
            m = re.search(r"int8_conv_gather_kernelILb([01])ELi(\d+)E", name)
            if m:
                name = f"int8_conv_gather_kernel<vec {m[1]}, BN {m[2]}>"
            m = re.search(r"int8_quantize_kernelI(f|13__nv_bfloat16)E", name)
            if m:
                name = ("int8_quantize_kernel<"
                        f"{'fp32' if m[1] == 'f' else 'bf16'}>")
        elif "registers" in line or "spill" in line:
            log(f"  ptxas {name[:72]}: {line.split(':', 1)[-1].strip()}")


def phase_kernels(seed: int):
    """Kernel vs plain version on every shape, and the 9 UNet shapes timed
    at N=2 and at N=8 (the served batch) in bf16; returns (max_abs_err,
    kernel ms, cuDNN ms, bound ms summed over the 9 UNet shapes at N=2 in
    bf16)."""
    import torch

    from mdeical_image_segmentation_tpu_torch.ops import _build
    from mdeical_image_segmentation_tpu_torch.ops.fused_conv import (
        fused_double2d,
        fused_double2d_reference,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    _build.load()
    log(f"[phase 1] kernel library {_build.library_path().name} ready in "
        f"{time.time() - t0:.2f} s")
    _log_ptxas(_build.build_log_path().read_text())

    gen = torch.Generator(device="cuda").manual_seed(seed)
    max_err = 0.0
    ms = plain_ms = bound = 0.0
    log(f"{'case':9s} {'dtype':8s} {'N,H,W,Ci,C1,Co':28s} {'err y':>10s} "
        f"{'err z':>10s} {'kernel ms':>10s} {'cuDNN ms':>10s}  kernel rate")
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        for name, shape in DC_SHAPES + RAGGED_SHAPES:
            args = _inputs(shape, dtype, gen)
            y, z = fused_double2d(*args)
            y_only, no_z = fused_double2d(*args, with_z=False)
            y_ref, z_ref = fused_double2d_reference(*args)
            torch.cuda.synchronize()
            if no_z is not None or not torch.equal(y, y_only):
                raise AssertionError(f"{name}: with_z=False changed y")
            errs = []
            for what, got, want in (("y", y, y_ref), ("z", z, z_ref)):
                got, want = got.float(), want.float()
                if not torch.isfinite(got).all():
                    raise AssertionError(f"{name} {dtype}: non-finite {what}")
                errs.append((got - want).abs().max().item())
                if not torch.allclose(got, want, rtol=tol, atol=tol):
                    raise AssertionError(
                        f"{name} {dtype}: {what} differs from the plain "
                        f"version by {errs[-1]:.3e} (rtol = atol = {tol})")
            max_err = max(max_err, *errs)
            k_ms = _median_ms(lambda: fused_double2d(*args, with_z=False))
            p_ms = _median_ms(
                lambda: fused_double2d_reference(*args, with_z=False))
            flop, nbytes = _dc_flop_bytes(shape, args[0].element_size())
            if dtype == torch.bfloat16 and name.startswith("DC"):
                ms += k_ms
                plain_ms += p_ms
                bound += _bound_ms(flop, nbytes, PEAK_BF16)[0]
            log(f"{name:9s} {str(dtype)[6:]:8s} {str(shape):28s} "
                f"{errs[0]:10.3e} {errs[1]:10.3e} {k_ms:10.4f} {p_ms:10.4f}  "
                f"{_rate(flop, k_ms, dtype)}")
            del args, y, z, y_only, y_ref, z_ref
    log(f"[phase 1] ok: max |kernel - plain| = {max_err:.3e}; 9 UNet shapes "
        f"in bf16 at N=2: kernel {ms:.4f} ms, cuDNN pair {plain_ms:.4f} ms, "
        f"bound {bound:.4f} ms")

    # the served batches: the launcher picks the tile from the grid, so each
    # device batch size the engine forms (1, 2, 4, 8) runs its own code;
    # y and z against the plain version at each, then N=8 timed
    n8_ms = n8_plain = n8_bound = 0.0
    for name, shape in DC_SHAPES:
        for n in SERVED_SIZES:
            if n == shape[0]:
                continue  # compared above
            args = _inputs((n, *shape[1:]), torch.bfloat16, gen)
            y, z = fused_double2d(*args)
            y_ref, z_ref = fused_double2d_reference(*args)
            for what, got, want in (("y", y, y_ref), ("z", z, z_ref)):
                got, want = got.float(), want.float()
                err = (got - want).abs().max().item()
                if (not torch.isfinite(got).all()
                        or not torch.allclose(got, want, rtol=BF16_TOL,
                                              atol=BF16_TOL)):
                    raise AssertionError(
                        f"{name} bf16 N={n}: {what} differs from the plain "
                        f"version by {err:.3e} (rtol = atol = {BF16_TOL})")
                max_err = max(max_err, err)
            del y, z, y_ref, z_ref
        shape = (SERVED_BATCH, *shape[1:])
        args = _inputs(shape, torch.bfloat16, gen)
        k_ms = _median_ms(lambda: fused_double2d(*args, with_z=False))
        p_ms = _median_ms(
            lambda: fused_double2d_reference(*args, with_z=False))
        flop, nbytes = _dc_flop_bytes(shape, 2)
        n8_ms += k_ms
        n8_plain += p_ms
        n8_bound += _bound_ms(flop, nbytes, PEAK_BF16)[0]
        log(f"{name:9s} {'bfloat16':8s} {str(shape):28s} {'':10s} {'':10s} "
            f"{k_ms:10.4f} {p_ms:10.4f}  {_rate(flop, k_ms, torch.bfloat16)}")
        del args
    log(f"[phase 1] 9 UNet shapes in bf16 at N={SERVED_BATCH} (the served "
        f"batch): kernel {n8_ms:.4f} ms, cuDNN pair {n8_plain:.4f} ms, bound "
        f"{n8_bound:.4f} ms; y and z match at N = {SERVED_SIZES}; max |kernel"
        f" - plain| over all = {max_err:.3e}")
    return max_err, ms, plain_ms, bound


def _plain_probs(model, x_u8):
    """The model's forward with every DoubleConv on its plain version."""
    import torch

    from mdeical_image_segmentation_tpu_torch.models import crop_and_concat
    from mdeical_image_segmentation_tpu_torch.ops.fused_conv import (
        fused_double2d_reference,
    )
    from mdeical_image_segmentation_tpu_torch.ops.image import max_pool2d

    unet = model.module

    def dc(i, t):
        m = getattr(unet, f"DoubleConvolution_{i}")
        w1, b1 = m.TorchConv_0.hwio()
        w2, b2 = m.TorchConv_1.hwio()
        return fused_double2d_reference(t, w1, b1, w2, b2, with_z=False)[0]

    with torch.inference_mode():
        x = (x_u8.float() / 255.0).to(model.compute_dtype)
        skips = []
        for i in range(unet.levels):
            x = dc(i, x)
            skips.append(x)
            x = max_pool2d(x, 2)
        x = dc(unet.levels, x)
        for i in range(unet.levels):
            x = getattr(unet, f"UpSample_{i}")(x)
            x = crop_and_concat(x, skips.pop())
            x = dc(unet.levels + 1 + i, x)
        return torch.sigmoid(unet.TorchConv_0(x).float())


def _post(port: int, payload: dict):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/", json.dumps(payload),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _get(port: int, path: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def filtered_png(arr, ftype: int) -> bytes:
    """8-bit grey (H, W) or RGB (H, W, 3) PNG bytes with every row under
    filter ``ftype`` (3 Average, 4 Paeth), written with zlib and raw
    filtered scanlines (the card's machine has no PIL)."""
    import struct
    import zlib

    import numpy as np

    h, w = arr.shape[:2]
    ch = 1 if arr.ndim == 2 else arr.shape[2]
    rows = arr.reshape(h, w * ch).astype(np.int32)
    b = np.vstack([np.zeros((1, w * ch), np.int32), rows[:-1]])  # above
    a = np.hstack([np.zeros((h, ch), np.int32), rows[:, :-ch]])  # left
    c = np.hstack([np.zeros((h, ch), np.int32), b[:, :-ch]])     # above-left
    if ftype == 3:
        pred = (a + b) >> 1
    elif ftype == 4:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    else:
        raise ValueError(f"filter {ftype}: 3 or 4")
    body = ((rows - pred) & 0xFF).astype(np.uint8)
    raw = np.hstack([np.full((h, 1), ftype, np.uint8), body]).tobytes()

    def chunk(t, data):
        return (struct.pack(">I", len(data)) + t + data
                + struct.pack(">I", zlib.crc32(t + data)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if ch == 1 else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


SCAN_SIZES = [(256, 256), (200, 310), (384, 384), (97, 130)]


def unet2d_bundle(seed: int, workdir: str, in_channels: int = 1) -> str:
    """Phase 2's model: the base-64 bf16 classic UNet from a seeded
    generator (``in_channels`` 1, or 3 as DRIVE's), saved with
    ``save_pretrained``; returns the bundle's path."""
    import torch

    from mdeical_image_segmentation_tpu_torch.models import (
        UNetConfig,
        UNetModel,
    )

    config = UNetConfig(in_channels=in_channels, out_channels=1,
                        unet_type="UNet", base_features=64,
                        compute_dtype="bfloat16")
    bundle = os.path.join(workdir, "unet2d_base64_bf16"
                          + ("" if in_channels == 1 else f"_c{in_channels}"))
    UNetModel(config, device="cpu",
              generator=torch.Generator().manual_seed(seed)
              ).save_pretrained(bundle)
    return bundle


def scan_pngs(seed: int, workdir: str, count: int = 16):
    """Phase 2's synthetic scans: a bright disc on noise at the sizes of
    ``SCAN_SIZES`` in turn, every third one RGB, written as PNGs; returns
    (paths, arrays)."""
    import numpy as np

    from mdeical_image_segmentation_tpu_torch.utils import png

    rng = np.random.default_rng(seed)
    images, arrays = [], []
    for i in range(count):
        h, w = SCAN_SIZES[i % len(SCAN_SIZES)]
        yy, xx = np.mgrid[:h, :w]
        blob = (((yy - h / 2) ** 2 + (xx - w / 3) ** 2) < (min(h, w) / 3) ** 2)
        noise = rng.integers(0, 60, (h, w))
        grey = (blob * 150 + noise).astype(np.uint8)
        arr = grey if i % 3 else np.stack([grey, grey // 2, 255 - grey], -1)
        path = os.path.join(workdir, f"scan_{i:02d}.png")
        png.write(path, arr)
        images.append(path)
        arrays.append(arr)
    return images, arrays


def phase_serve(seed: int, workdir: str):
    """Serve the base-64 bf16 UNet at 256²; returns the kernel launch count
    of the served traffic."""
    import numpy as np
    import torch

    from mdeical_image_segmentation_tpu_torch.data.png2d import nearest_resize
    from mdeical_image_segmentation_tpu_torch.models import UNetModel
    from mdeical_image_segmentation_tpu_torch.ops.fused_conv import (
        fused_double2d,
    )
    from mdeical_image_segmentation_tpu_torch.serve import (
        ModelRegistry,
        SegmentationServer,
    )
    from mdeical_image_segmentation_tpu_torch.utils import png

    res, max_batch, clients = 256, 8, 8
    bundle = unet2d_bundle(seed, workdir)

    t0 = time.time()
    registry = ModelRegistry()
    registry.register_unet2d("unet", bundle, resolution=res, device="cuda",
                             max_batch=max_batch)
    log(f"[phase 2] registered (load + warm-up of batches 1..{max_batch}) "
        f"in {time.time() - t0:.2f} s")

    images, arrays = scan_pngs(seed, workdir)
    sizes = SCAN_SIZES
    # the first 4 again (RGB 256², grey 200x310, grey 384², RGB 97x130),
    # each with every row under Average (3) and under Paeth (4): real
    # clients' PNGs, decoded by the C unfilter
    filtered = []
    for k in range(4):
        for ftype in (3, 4):
            path = os.path.join(workdir, f"scan_{k:02d}_filter{ftype}.png")
            with open(path, "wb") as f:
                f.write(filtered_png(arrays[k], ftype))
            if not np.array_equal(png.read(path, "L"),
                                  png.read(images[k], "L")):
                raise AssertionError(f"{path}: decodes differently from the "
                                     "filter-0 copy")
            filtered.append((k, path))
    images += [path for _, path in filtered]

    srv = SegmentationServer(registry, output_dir=os.path.join(workdir, "masks"),
                             max_batch=max_batch, max_wait_ms=5.0)
    port = srv.start(host="127.0.0.1", port=0).server_address[1]
    modes = ("png", "mask", "path")
    replies = [None] * len(images)
    try:
        occ0 = srv.engine.occupancy().get("unet", {"batches": 0})["batches"]
        fused_double2d.launches = 0

        def client(k):
            for i in range(k, len(images), clients):
                replies[i] = _post(port, {"image_path": images[i],
                                          "return": modes[i % 3]})

        t0 = time.time()
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.time() - t0
        launches = fused_double2d.launches
        if any(t.is_alive() for t in threads):
            raise AssertionError("a client did not finish within 600 s")
        stats = _get(port, "/stats")
    finally:
        srv.stop()
    batches = stats["batch_occupancy"]["unet"]["batches"] - occ0
    log(f"[phase 2] {len(images)} requests from {clients} clients in "
        f"{wall:.3f} s; /stats: {json.dumps(stats)}")

    masks = []
    for i, (status, body) in enumerate(replies):
        if status != 200 or body.get("status") != 200:
            raise AssertionError(f"request {i}: {status} {body}")
        mode = modes[i % 3]
        if mode == "png":
            mask = png.convert(png.decode(base64.b64decode(body["response"])),
                               "L")
        elif mode == "mask":
            mask = np.asarray(body["response"], np.uint8)
        else:
            mask = png.read(body["response"], "L") // 255
        if mask.shape != (res, res) or mask.max() > 1:
            raise AssertionError(f"request {i}: bad mask {mask.shape}")
        masks.append(mask)

    if batches <= 0 or launches != 18 * batches:
        raise AssertionError(f"{launches} kernel launches for {batches} "
                             "device batches (want 18 per batch: conv1 and "
                             "conv2 of 9 DoubleConvs)")
    for j, (k, path) in enumerate(filtered):
        if not np.array_equal(masks[16 + j], masks[k]):
            raise AssertionError(f"{path}: its mask differs from the filter-0 "
                                 "copy's")
    log(f"[phase 2] {launches} kernel launches for {batches} device batches "
        f"(9 DoubleConvs of 2 launches each); all {len(images)} replies 200 "
        f"with {res}x{res} masks; the {len(filtered)} Average- and "
        f"Paeth-filtered copies decode to the filter-0 pixels and get the "
        f"same masks")

    # the serving copy, as register_unet2d holds it
    model = UNetModel.from_pretrained(bundle, device="cuda").for_inference()
    entry = registry.get("unet")
    for i in range(4):
        x = nearest_resize(png.read(images[i], "L")[..., None], (res, res))
        plain = _plain_probs(model, torch.from_numpy(x[None]).cuda())
        plain = plain.cpu().numpy()[0, ..., 0]
        served_probs = entry.probs_forward(
            x[None].astype(np.float32) / 255.0)[0, ..., 0]
        err = float(np.abs(served_probs - plain).max())
        agree = float(np.mean(masks[i] == (plain > 0.5)))
        log(f"  image {i} {sizes[i % 4]}: mask agreement {agree:.6f}, "
            f"max |p_kernel - p_plain| {err:.3e}, p in [{plain.min():.4f}, "
            f"{plain.max():.4f}], mask fg share {masks[i].mean():.4f}")
        if err > PROB_TOL or agree < MASK_AGREEMENT:
            raise AssertionError(f"image {i}: served output disagrees with "
                                 "the plain DoubleConv")

    # where the time goes at the model layer: one full device batch through
    # the served forward (kernel DoubleConvs) and through the plain path
    x8 = np.stack([nearest_resize(png.read(p, "L")[..., None], (res, res))
                   for p in images[:max_batch]])
    x8_dev = torch.from_numpy(x8).cuda()
    # a full device batch through the served forward (the tiles of N=8)
    err8 = float(np.abs(entry.probs_forward(x8.astype(np.float32) / 255.0)
                        - _plain_probs(model, x8_dev).cpu().numpy()).max())
    log(f"  batch of {max_batch}: max |p_kernel - p_plain| {err8:.3e}")
    if err8 > PROB_TOL:
        raise AssertionError(f"a served batch of {max_batch} disagrees with "
                             "the plain DoubleConv")
    served_ms = _median_ms(lambda: entry.dispatch(x8), repeats=5)
    plain_ms = _median_ms(lambda: _plain_probs(model, x8_dev), repeats=5)
    log(f"[phase 2] forward of a batch of {max_batch} at {res}²: served "
        f"(kernel DoubleConvs, uint8 in, mask out) {served_ms:.3f} ms, plain "
        f"(cuDNN DoubleConvs, probabilities out) {plain_ms:.3f} ms")
    return launches


# ---------------------------------------------------------------------------
# 3D sliding-window inference (UNet3D / ResidualUNet3D 'gcr')
# ---------------------------------------------------------------------------

DEVICE = "cuda"
PREDICT_YML = os.path.join(ROOT, "configs", "unet3d_predict.yml")
VOLUME_3D = (80, 340, 510)      # 1 x 2 x 3 patches of 80x170x170: 6 patches
RESIDUAL_MODEL = {"name": "ResidualUNet3D", "in_channels": 1,
                  "out_channels": 1, "f_maps": 32, "num_levels": 5,
                  "layer_order": "gcr", "final_sigmoid": True}
RESIDUAL_SLICES = {"name": "SliceBuilder", "patch_shape": [48, 96, 96],
                   "stride_shape": [48, 96, 96], "halo_shape": [8, 16, 16]}
VOLUME_RESIDUAL = (48, 192, 288)  # 1 x 2 x 3 patches: 6 patches
UNET3D_MAP_TOL = 1e-3     # fp32 averaged map, kernel vs plain (TF32 off)
RESIDUAL_MAP_TOL = 2e-3   # its 1x1 shortcut of one input channel feeds
                          # GroupNorm channels whose E[x²] − mean² cancels
SERVE3D_PROB_TOL = 1e-3
GN_TOL = 1e-4             # per-channel mean and rsqrt(var + eps), fp32 sums
AFFINE_FP32_TOL = 1e-6    # both round x·a and x·a + b the same way
KERNELS_3D = ("gcr_conv3d", "gn_stats", "gn_affine", "gn_bwd_reduce",
              "gn_bwd_dx", "overlap_add")


def read_yaml_subset(path: str) -> dict:
    """A config file such as configs/unet3d_predict.yml or
    configs/unet3d_train.yml, read with the port's YAML reader (the card's
    machine has no PyYAML)."""
    from mdeical_image_segmentation_tpu_torch.utils import yaml_io

    return yaml_io.load(path)


def _counts():
    from mdeical_image_segmentation_tpu_torch.ops import fused_conv, norm, overlap

    # inside plain_path the plain versions stand in: they launch nothing
    fns = {"gcr_conv3d": fused_conv.fused_conv3d,
           "gn_stats": norm.gn_channel_sums, "gn_affine": norm.gn_affine,
           "gn_bwd_reduce": norm.gn_bwd_reduce, "gn_bwd_dx": norm.gn_bwd_dx,
           "overlap_add": overlap.overlap_add_into}
    return {k: getattr(fn, "launches", 0) for k, fn in fns.items()}


def _zero_counts():
    from mdeical_image_segmentation_tpu_torch.ops import fused_conv, norm, overlap

    for fn in (fused_conv.fused_conv3d, norm.gn_channel_sums, norm.gn_affine,
               norm.gn_bwd_reduce, norm.gn_bwd_dx, overlap.overlap_add_into):
        fn.launches = 0
        fn.launches_by_dtype.clear()


def _dtype_counts():
    """{kernel: {"float32": n, "bfloat16": n}}: the wrappers' launches split
    by the dtype of the tensor each launch read."""
    import torch

    from mdeical_image_segmentation_tpu_torch.ops import fused_conv, norm, overlap

    fns = {"gcr_conv3d": fused_conv.fused_conv3d,
           "gn_stats": norm.gn_channel_sums, "gn_affine": norm.gn_affine,
           "gn_bwd_reduce": norm.gn_bwd_reduce, "gn_bwd_dx": norm.gn_bwd_dx,
           "overlap_add": overlap.overlap_add_into}
    return {k: {name: fn.launches_by_dtype[dt] for name, dt in
                (("float32", torch.float32), ("bfloat16", torch.bfloat16))}
            for k, fn in fns.items()}


class plain_path:
    """Within this block the models, the predictor, the trainers and the
    server run every kernel's plain PyTorch version on the card (cuDNN
    conv2d pair for kernel 1, cuDNN conv3d, plain GN forward and backward,
    plain overlap-add): the comparison pipeline.  Nothing of the port
    switches by itself; only this script swaps the functions."""

    def __enter__(self):
        from mdeical_image_segmentation_tpu_torch.infer import predictor
        from mdeical_image_segmentation_tpu_torch.models import layers2d
        from mdeical_image_segmentation_tpu_torch.ops import fused_conv, norm, overlap

        self.saved = [
            (fused_conv, "fused_double2d",
             fused_conv.fused_double2d_reference),
            (layers2d, "fused_double2d", fused_conv.fused_double2d_reference),
            (norm, "gn_channel_sums", norm.gn_channel_sums_reference),
            (norm, "gn_affine", norm.gn_affine_reference),
            (norm, "gn_bwd_reduce", norm.gn_bwd_reduce_reference),
            (norm, "gn_bwd_dx", norm.gn_bwd_dx_reference),
            (fused_conv, "fused_conv3d", fused_conv.fused_conv3d_reference),
            (predictor, "overlap_add_into",
             overlap.overlap_add_into_reference),
        ]
        self.saved = [(m, n, getattr(m, n), f) for m, n, f in self.saved]
        for m, n, _, f in self.saved:
            setattr(m, n, f)
        return self

    def __exit__(self, *exc):
        for m, n, orig, _ in self.saved:
            setattr(m, n, orig)


def _record_shapes(model, shapes: set, tag: str = ""):
    """Forward pre-hooks that note the input shape of every fused 'gcr'
    SingleConv (with Co and ``tag``, the model's name) and GroupNorm
    module: the shapes kernel checks run at."""
    from mdeical_image_segmentation_tpu_torch.models import SingleConv
    from mdeical_image_segmentation_tpu_torch.ops.norm import GroupNorm

    def conv_hook(mod, args):
        if mod.fused:
            x = args[0]
            shapes.add(("gcr", tuple(x.shape), mod.TorchConv_0.weight.shape[0],
                        tag))
            shapes.add(("stats", tuple(x.shape)))

    def gn_hook(mod, args):
        shapes.add(("stats", tuple(args[0].shape)))
        shapes.add(("affine", tuple(args[0].shape)))

    handles = []
    for m in model.modules():
        if isinstance(m, SingleConv):
            handles.append(m.register_forward_pre_hook(conv_hook))
        elif isinstance(m, GroupNorm):
            handles.append(m.register_forward_pre_hook(gn_hook))
    return handles


def _timed_batches(pred, rec):
    """Wrap the predictor's batch forward to time each batch (synchronised
    host clock) and note the kernel launches it made."""
    import torch

    orig = pred._predict_batch_device

    def timed(input):
        torch.cuda.synchronize()
        before, t0 = _counts(), time.perf_counter()
        out = orig(input)
        torch.cuda.synchronize()
        after = _counts()
        rec.append(((time.perf_counter() - t0) * 1e3,
                    {k: after[k] - before[k] for k in after}))
        return out

    pred._predict_batch_device = timed


def _record_overlap_batches(channels, raw, slices, batch_size, shapes):
    """The overlap-add calls the predictor makes: patch batch shape, volume,
    starts, valid mask (the tail padded with the last start, weight 0) and
    the halo the patches are a stripped view of."""
    from mdeical_image_segmentation_tpu_torch.data.slice_builder import (
        SliceBuilder,
    )

    windows = SliceBuilder(raw, None, None, slices["patch_shape"],
                           slices["stride_shape"]).raw_slices
    for b0 in range(0, len(windows), batch_size):
        starts = [tuple(s.start for s in w) for w in
                  windows[b0:b0 + batch_size]]
        valid = [1] * len(starts) + [0] * (batch_size - len(starts))
        starts += [starts[-1]] * (batch_size - len(starts))
        shapes.add(("overlap", (batch_size, *slices["patch_shape"], channels),
                    tuple(raw.shape), tuple(starts), tuple(valid),
                    tuple(slices["halo_shape"])))


def seeded_volume(shape, seed):
    import numpy as np

    v = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return ((v - v.mean()) / v.std()).astype(np.float32)


def _run_predictor(model, config, raw, slices, batch_size, shapes, tag):
    """One pass of the sliding-window predictor, kernel path then plain
    path; returns (maps, plain maps, per-batch records, launches)."""
    import torch

    from mdeical_image_segmentation_tpu_torch.data.volume_utils import (
        padded_patch_batches,
    )
    from mdeical_image_segmentation_tpu_torch.infer import get_predictor

    def batches():
        return padded_patch_batches(raw, slices, batch_size)

    handles = _record_shapes(model, shapes, tag)
    _record_overlap_batches(model.out_channels, raw, slices, batch_size,
                            shapes)
    pred = get_predictor(model, None, config)
    rec = []
    _timed_batches(pred, rec)
    _zero_counts()
    t0 = time.perf_counter()
    acc, cnt = pred._device_accumulate(batches(), raw.shape,
                                       slices["halo_shape"])
    wall = time.perf_counter() - t0
    launches = _counts()
    for h in handles:
        h.remove()
    torch.cuda.empty_cache()
    with plain_path():
        plain = get_predictor(model, None, config)
        plain_rec = []
        _timed_batches(plain, plain_rec)
        t0 = time.perf_counter()
        p_acc, p_cnt = plain._device_accumulate(batches(), raw.shape,
                                                slices["halo_shape"])
        plain_wall = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return (acc, cnt), (p_acc, p_cnt), rec, plain_rec, launches, wall, plain_wall


def _check_maps(name, maps, plain, tol):
    import numpy as np

    (acc, cnt), (p_acc, p_cnt) = maps, plain
    if not np.array_equal(cnt, p_cnt) or cnt.min() < 1:
        raise AssertionError(f"{name}: count maps differ or leave voxels "
                             "uncovered")
    avg, p_avg = acc / cnt, p_acc / p_cnt
    if not np.isfinite(avg).all():
        raise AssertionError(f"{name}: non-finite averaged map")
    err = float(np.abs(avg - p_avg).max())
    scale = max(1.0, float(np.abs(p_avg).max()))
    log(f"  averaged map {avg.shape}: max |kernel - plain| {err:.3e} (limit "
        f"{tol} x {scale:.3f}), values in [{avg.min():.4f}, {avg.max():.4f}],"
        f" counts in [{cnt.min():.0f}, {cnt.max():.0f}]")
    if err > tol * scale:
        raise AssertionError(f"{name}: averaged map differs from the plain "
                             f"pipeline by {err:.3e}")
    return err


def phase_unet3d_predictor(seed: int, workdir: str, shapes: set):
    """UNet3D of configs/unet3d_predict.yml at full width through the port's
    checkpoint I/O and sliding-window predictor."""
    import torch

    from mdeical_image_segmentation_tpu_torch.models import get_model
    from mdeical_image_segmentation_tpu_torch.train import (
        load_checkpoint,
        save_checkpoint,
    )
    from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
        flax_to_state_dict,
        state_dict_to_flax,
    )

    torch.backends.cudnn.allow_tf32 = False
    cfg = read_yaml_subset(PREDICT_YML)
    model_cfg, slices = cfg["model"], cfg["loaders"]["test"]["slice_builder"]
    batch_size = cfg["loaders"]["batch_size"]
    log(f"[phase 3] model {model_cfg}; predictor {cfg['predictor']}; "
        f"batch {batch_size}; slices {slices}")
    cpu_model = get_model(model_cfg,
                          generator=torch.Generator().manual_seed(seed))
    ckpt = save_checkpoint(
        {"model_state_dict": state_dict_to_flax(cpu_model.state_dict()),
         "best_eval_score": 0.0, "num_iterations": 0}, True, workdir)
    model = get_model(model_cfg, device=DEVICE)
    model.load_state_dict(flax_to_state_dict(
        load_checkpoint(ckpt)["model_state_dict"]["params"]))
    model.eval()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {n_params} parameters, checkpoint {os.path.getsize(ckpt)} bytes")

    raw = seeded_volume(VOLUME_3D, seed)
    config = {"model": model_cfg, "predictor": cfg["predictor"]}
    maps, plain, rec, plain_rec, launches, wall, plain_wall = _run_predictor(
        model, config, raw, slices, batch_size, shapes, "UNet3D")
    for i, ((ms, n), (p_ms, _)) in enumerate(zip(rec, plain_rec)):
        log(f"  batch {i}: kernel path {ms:.1f} ms ({n}), plain path "
            f"{p_ms:.1f} ms")
        if n["gcr_conv3d"] != 14 or n["gn_stats"] != 14:
            raise AssertionError(f"batch {i}: {n}, want 14 gcr_conv3d and "
                                 "14 gn_stats launches")
    if launches["overlap_add"] != len(rec) or len(rec) != 2:
        raise AssertionError(f"{launches} for {len(rec)} batches: want one "
                             "overlap_add per batch, 2 batches")
    log(f"  whole volume: kernel path {wall:.2f} s, plain path "
        f"{plain_wall:.2f} s; launches {launches}")
    err = _check_maps("UNet3D", maps, plain, UNET3D_MAP_TOL)
    return model_cfg, ckpt, launches, err


def phase_residual_predictor(seed: int, shapes: set):
    """ResidualUNet3D f_maps 32, 5 levels (bench.py's residual row) through
    the same predictor: runs the GroupNorm affine kernel (conv3, 'gc')."""
    import torch

    from mdeical_image_segmentation_tpu_torch.models import get_model

    cfg = read_yaml_subset(PREDICT_YML)
    model = get_model(RESIDUAL_MODEL,
                      generator=torch.Generator().manual_seed(seed + 1))
    model = model.to(DEVICE).eval()
    raw = seeded_volume(VOLUME_RESIDUAL, seed + 1)
    config = {"model": RESIDUAL_MODEL, "predictor": cfg["predictor"]}
    maps, plain, rec, plain_rec, launches, wall, plain_wall = _run_predictor(
        model, config, raw, RESIDUAL_SLICES, cfg["loaders"]["batch_size"],
        shapes, "ResidualUNet3D")
    for i, ((ms, n), (p_ms, _)) in enumerate(zip(rec, plain_rec)):
        log(f"  batch {i}: kernel path {ms:.1f} ms ({n}), plain path "
            f"{p_ms:.1f} ms")
        blocks = 2 * RESIDUAL_MODEL["num_levels"] - 1  # one ResNetBlock each
        if (n["gcr_conv3d"], n["gn_stats"], n["gn_affine"]) != (
                blocks, 2 * blocks, blocks):
            raise AssertionError(f"batch {i}: {n}, want {blocks} gcr_conv3d, "
                                 f"{2 * blocks} gn_stats and {blocks} "
                                 "gn_affine launches")
    log(f"  whole volume: kernel path {wall:.2f} s, plain path "
        f"{plain_wall:.2f} s; launches {launches}")
    err = _check_maps("ResidualUNet3D", maps, plain, RESIDUAL_MAP_TOL)
    return launches, err


def phase_serve3d(seed: int, workdir: str, model_cfg, ckpt: str):
    """register_unet3d on the UNet3D checkpoint at 256², served over HTTP."""
    import numpy as np
    import torch

    from mdeical_image_segmentation_tpu_torch.data.png2d import nearest_resize
    from mdeical_image_segmentation_tpu_torch.serve import (
        ModelRegistry,
        SegmentationServer,
    )
    from mdeical_image_segmentation_tpu_torch.utils import png

    res, max_batch, clients = 256, 8, 4
    t0 = time.time()
    registry = ModelRegistry()
    registry.register_unet3d("unet3d", ckpt, model_cfg, resolution=res,
                             device=DEVICE, max_batch=max_batch)
    log(f"[phase 5] registered (load + warm-up of batches 1..{max_batch}, "
        f"depth 8) in {time.time() - t0:.2f} s")
    rng = np.random.default_rng(seed)
    images = []
    for i in range(8):
        h, w = (256, 256) if i % 2 else (300, 220)
        path = os.path.join(workdir, f"slice_{i}.png")
        png.write(path, rng.integers(0, 256, (h, w)).astype(np.uint8))
        images.append(path)
    srv = SegmentationServer(registry, output_dir=os.path.join(workdir, "m3"),
                             max_batch=max_batch, max_wait_ms=5.0)
    port = srv.start(host="127.0.0.1", port=0).server_address[1]
    replies = [None] * len(images)
    try:
        _zero_counts()

        def client(k):
            for i in range(k, len(images), clients):
                replies[i] = _post(port, {"image_path": images[i],
                                          "return": "png"})

        t0 = time.time()
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.time() - t0
        launches = _counts()
        if any(t.is_alive() for t in threads):
            raise AssertionError("a client did not finish within 600 s")
        stats = _get(port, "/stats")
    finally:
        srv.stop()
    for i, (status, body) in enumerate(replies):
        if status != 200 or body.get("status") != 200:
            raise AssertionError(f"3D request {i}: {status} {body}")
        mask = png.convert(png.decode(base64.b64decode(body["response"])), "L")
        if mask.shape != (res, res) or mask.max() > 1:
            raise AssertionError(f"3D request {i}: bad mask {mask.shape}")
    if launches["gcr_conv3d"] == 0 or launches["gn_stats"] == 0:
        raise AssertionError(f"3D serving launched {launches}")
    log(f"[phase 5] {len(images)} requests from {clients} clients in "
        f"{wall:.3f} s, all 200 with {res}x{res} masks; launches {launches}; "
        f"/stats {json.dumps(stats)}")
    entry = registry.get("unet3d")
    x = np.stack([nearest_resize(png.read(p, "L")[..., None], (res, res))
                  for p in images]).astype(np.float32) / 255.0
    # every device batch size the engine forms: each picks its own tiles
    for n in SERVED_SIZES:
        probs = entry.probs_forward(x[:n])
        with plain_path():
            plain = entry.probs_forward(x[:n])
        err = float(np.abs(probs - plain).max())
        log(f"  served probabilities vs plain path, batch of {n}: max |diff| "
            f"{err:.3e} (limit {SERVE3D_PROB_TOL}), p in [{plain.min():.4f}, "
            f"{plain.max():.4f}]")
        if not np.isfinite(probs).all() or err > SERVE3D_PROB_TOL:
            raise AssertionError(f"3D serving disagrees with the plain path "
                                 f"at a batch of {n}")
    torch.cuda.empty_cache()
    return launches


def _compare(name, got, want, tol, exact=False):
    import torch

    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs().max().item()
    ok = torch.equal(got, want) if exact else torch.allclose(
        got, want, rtol=tol, atol=tol)
    if not ok:
        raise AssertionError(f"{name}: kernel differs from the plain version "
                             f"by {err:.3e} (tolerance {tol}, exact={exact})")
    return err


def _time_turns(*fns, budget_s: float = 0.6):
    """Median ms of each function (kernel, plain version, library call),
    timed in turns with CUDA events after one warm-up each; fewer repeats
    for the long calls."""
    import torch

    def once(fn):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e)

    first = sum(once(fn) for fn in fns)
    repeats = max(1, min(10, int(budget_s * 1e3 / max(first, 1e-3))))
    times = [[] for _ in fns]
    for _ in range(repeats):
        for t, fn in zip(times, fns):
            t.append(once(fn))
    return tuple(statistics.median(t) for t in times)


def _rand(gen, shape, dtype, scale=1.0, shift=0.0):
    import torch

    t = torch.randn(shape, device=DEVICE, generator=gen)
    return t.mul_(scale).add_(shift).to(dtype)


def _record_header():
    log(f"{'kernel':13s} {'dtype':8s} {'case':44s} {'max err':>10s} "
        f"{'kernel ms':>11s} {'plain ms':>11s} {'library ms':>11s} "
        f"{'bound ms':>10s}")


def _new_records(*kernels):
    return {k: {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": None,
                "device_ms": None, "bound_ms": 0.0, "op_ms": 0.0,
                "byte_ms": 0.0}
            for k in kernels}


def _record(out, kernel, case, dtype, err, k_ms, p_ms, model_shape, flop,
            nbytes, peak, lib_ms=None, dev_ms=None):
    """Log one kernel-vs-plain case; keep the kernel's worst error and the
    fp32 model shapes' summed kernel, plain, library, device and bound times
    (the bound per shape: FLOP at ``peak`` or bytes at the HBM rate, the
    larger)."""
    import torch

    rec = out[kernel]
    rec["err"] = max(rec["err"], err)
    bound = _bound_ms(flop, nbytes, peak)[0]
    if model_shape and dtype == torch.float32:
        rec["ms"] += k_ms
        rec["plain_ms"] += p_ms
        rec["bound_ms"] += bound
        rec["op_ms"] += flop / peak * 1e3
        rec["byte_ms"] += nbytes / HBM_BYTES_PER_S * 1e3
        for key, v in (("library_ms", lib_ms), ("device_ms", dev_ms)):
            if v is not None:
                rec[key] = (rec[key] or 0.0) + v
    lib = f"{lib_ms:11.3f}" if lib_ms is not None else f"{'none':>11s}"
    log(f"{kernel:13s} {str(dtype)[6:]:8s} {case:44s} {err:10.3e} "
        f"{k_ms:11.3f} {p_ms:11.3f} {lib} {bound:10.3f}")


def _add_sums(sums: dict, key, **vals) -> None:
    """Add one shape's times (window, device, library, ..., bound) into the
    totals of ``key`` (a shape set and dtype), counting the shapes."""
    tot = sums.setdefault(key, {"n": 0.0})
    tot["n"] += 1
    for name, v in vals.items():
        tot[name] = tot.get(name, 0.0) + v


def _log_sums(phase: int, kernel: str, sums: dict, library: str = "") -> None:
    """One line per (shape set, dtype) of ``_add_sums`` totals: the event
    window, the device time, the library call's where there is one, the
    bound and both shares."""
    for (label, dtype), t in sums.items():
        lib = ""
        if library:
            lib = f"; {library} window {t['library']:.4f} ms"
            if "library_device" in t:
                lib += f", device {_ms(t['library_device'])}"
        log(f"[phase {phase}] {kernel} over the {t['n']:.0f} {label}, "
            f"{str(dtype)[6:]}: event window {t['window']:.4f} ms, device "
            f"{_ms(t['device'])}{lib}; bound {t['bound']:.4f} ms (share: "
            f"window {_share(t['bound'], t['window'])}, device "
            f"{_share(t['bound'], t['device'])})")


def _same_bits(what: str, first, second) -> None:
    """Two calls' outputs must be identical, bit for bit."""
    import torch

    for a, b in zip(first, second):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: two calls on the same inputs "
                                 "differ (the reduction must be "
                                 "deterministic)")


def _elementwise(numel: int, ops_per_element: int, nbytes: float):
    """(FLOP, bytes, peak) of a streaming pass: fp32 ops on the CUDA
    cores."""
    return float(numel) * ops_per_element, float(nbytes), PEAK_FP32


def device_times(prof):
    """{kernel name: ms} of a ``torch.profiler`` run: the self device time
    of every kernel, summed by name."""
    by_name: dict = {}
    for evt in prof.key_averages():
        dev = getattr(evt, "self_device_time_total", None)
        if dev is None:
            dev = getattr(evt, "self_cuda_time_total", 0.0)
        if dev and evt.device_type.name == "CUDA":
            by_name[evt.key] = by_name.get(evt.key, 0.0) + dev / 1e3
    return by_name


def _device_ms_by(fn, names, launches: int = 1, repeats: int = 5,
                  tries: int = 3) -> dict:
    """Device time of one call of ``fn`` by kernel kind: for each of
    ``names`` (a substring of the names of one kind of kernel that ``fn``
    launches ``launches`` times a call), the mean self device time of the
    kernel events of that kind ``torch.profiler`` recorded over
    ``repeats`` calls after a warm-up, times ``launches``.  Host work
    between launches is not in it; the event window of ``_time_turns``
    holds both.  The tracer drops an event now and then, so each mean is
    over the events it kept; a profiled pass that kept none of some kind is
    run again, and after ``tries`` such passes every time is NaN: not
    measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(repeats):
                fn()
            torch.cuda.synchronize()
        sums = {n: [0.0, 0] for n in names}
        for evt in prof.key_averages():
            dev = getattr(evt, "self_device_time_total", None)
            if dev is None:
                dev = getattr(evt, "self_cuda_time_total", 0.0)
            if not dev or evt.device_type.name != "CUDA":
                continue
            for n in names:
                if n in evt.key:
                    sums[n][0] += dev / 1e3
                    sums[n][1] += evt.count
                    break
        if all(count for _, count in sums.values()):
            return {n: total / count * launches
                    for n, (total, count) in sums.items()}
    return {n: math.nan for n in names}


def _device_ms(fn, launches: int = 1, repeats: int = 5,
               tries: int = 3, name: str = "") -> float:
    """``_device_ms_by`` of the one kind of kernel whose name holds
    ``name`` (any kernel of ``fn`` by default)."""
    return _device_ms_by(fn, (name,), launches, repeats, tries)[name]


def _ms(v: float) -> str:
    return "not measured" if math.isnan(v) else f"{v:.4f} ms"


def _share(bound: float, ms: float) -> str:
    return "not measured" if math.isnan(ms) else f"{100 * bound / ms:.1f}%"


class _sync_debug_error:
    """``torch.cuda.set_sync_debug_mode("error")`` within the block: any
    synchronising CUDA call through PyTorch raises."""

    def __enter__(self):
        import torch

        self.prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        import torch

        torch.cuda.set_sync_debug_mode(self.prev)


def _overlap_work(pshape, vol, starts, valid, itemsize: int):
    """(FLOP, bytes) the overlap-add needs for these inputs: each valid
    patch read once (a mul and two adds per element), each element of the
    union of their windows read and written once in acc and cnt (fp32)."""
    import numpy as np

    p, pd, ph, pw, c = pshape
    cover = np.zeros(vol, bool)
    n_valid = 0
    for (z, y, x), w in zip(starts, valid):
        if w:
            cover[z:z + pd, y:y + ph, x:x + pw] = True
            n_valid += 1
    elems = n_valid * pd * ph * pw * c
    return 3.0 * elems, float(elems * itemsize + int(cover.sum()) * c * 16)


def _windows(vol, patch, stride):
    """Sliding-window starts over ``vol``, the last window flush with the
    end (the SliceBuilder's rule)."""
    import itertools

    axes = []
    for v, p, st in zip(vol, patch, stride):
        starts = list(range(0, v - p + 1, st))
        if starts[-1] != v - p:
            starts.append(v - p)
        axes.append(starts)
    return [list(s) for s in itertools.product(*axes)]


# the overlapping-window case at predictor size: patch 80x170x170 at stride
# 40x85x85 over 160x340x340 (27 windows; a voxel in up to 8), halo-stripped
# views of 112x234x234 outputs as the predictor passes them
OVERLAP_PATCH = (80, 170, 170)
OVERLAP_STRIDE = (40, 85, 85)
OVERLAP_VOLUME = (160, 340, 340)
OVERLAP_HALO = (16, 32, 32)


def phase_kernels_3d(seed: int, shapes: set, train_shapes):
    """Each 3D kernel against its plain version at every shape the two
    models produced in phases 3-4, plus ragged cases, in fp32 and bf16;
    kernel 2, 3a and 3b also against one library call (cuDNN conv3d,
    ``torch.var_mean``, ``torch.addcmul``); 3b also at the UNet3D training
    step's GroupNorm inputs; 3a, 3b and 4 also by device time; 3a's two
    calls on the same inputs give the same bits."""
    import torch
    import torch.nn.functional as F

    from mdeical_image_segmentation_tpu_torch.ops import fused_conv, norm, overlap

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    out = _new_records("gcr_conv3d", "gn_stats", "gn_affine", "overlap_add")
    unet = {"ms": 0.0, "library_ms": 0.0, "flop": 0.0}  # UNet3D shapes, fp32

    def rand(shape, dtype=torch.float32, scale=1.0, shift=0.0):
        return _rand(gen, shape, dtype, scale, shift)

    def coeffs(n, c):
        a = torch.rand((n, c), device=DEVICE, generator=gen) + 0.5
        return a, 0.5 * torch.randn((n, c), device=DEVICE, generator=gen)

    def record(*args, **kw):
        _record(out, *args, **kw)

    # (shape set, dtype) -> summed ms and bound
    stats_sums: dict = {}
    affine_sums: dict = {}
    overlap_sums: dict = {}
    sync_checked = 0
    gcr = sorted(s for s in shapes if s[0] == "gcr")
    stats = sorted(s for s in shapes if s[0] == "stats")
    affine = sorted(s for s in shapes if s[0] == "affine")
    overlaps = sorted(s for s in shapes if s[0] == "overlap")
    ragged_gcr = [((2, 5, 9, 11, 1), 32, 3, False), ((2, 4, 17, 13, 19), 70,
                  3, True), ((1, 3, 16, 16, 3), 64, 1, False),
                  ((1, 6, 12, 10, 40), 130, 1, True)]
    ragged_gn = [(2, 5, 9, 11, 3), (2, 6, 20, 17, 19), (1, 3, 7, 9, 300)]
    _record_header()
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        cases = [(s[1], s[2], 3, False, s[3]) for s in gcr] + [
            (*r, "") for r in ragged_gcr]
        for shape, co, kd, pre, model in cases:
            ci = shape[-1]
            x = rand(shape, dtype)
            k = rand((kd, 3, 3, ci, co), dtype, (9 * kd * ci) ** -0.5)
            a, b = coeffs(shape[0], ci)
            y = fused_conv.fused_conv3d(x, k, a, b, pre_relu=pre)
            ref = fused_conv.fused_conv3d_reference(x, k, a, b, pre_relu=pre)
            err = _compare(f"gcr_conv3d {shape}->{co}", y, ref,
                           BF16_TOL if bf16 else FP32_TOL)
            del y, ref
            xc, kc = x.permute(0, 4, 1, 2, 3), k.permute(4, 3, 0, 1, 2)
            k_ms, p_ms, l_ms = _time_turns(
                lambda: fused_conv.fused_conv3d(x, k, a, b, pre_relu=pre),
                lambda: fused_conv.fused_conv3d_reference(x, k, a, b,
                                                          pre_relu=pre),
                lambda: F.conv3d(xc, kc, padding=((kd - 1) // 2, 1, 1)))
            flop, nbytes = _gcr_flop_bytes(shape, co, kd, x.element_size())
            record("gcr_conv3d", f"{shape}->{co} kd{kd} pre{int(pre)}", dtype,
                   err, k_ms, p_ms, bool(model), flop, nbytes, _peak(dtype),
                   l_ms)
            log(f"{'':13s} {model or 'ragged':14s} kernel "
                f"{_rate(flop, k_ms, dtype)}; cuDNN conv3d "
                f"{_rate(flop, l_ms, dtype)}")
            if model == "UNet3D" and not bf16:
                unet["ms"] += k_ms
                unet["library_ms"] += l_ms
                unet["flop"] += flop
            del x, k, xc, kc
            torch.cuda.empty_cache()
        cases = [(s[1], True) for s in stats] + [(r, False) for r in ragged_gn]
        for shape, model_shape in cases:
            x = rand(shape, dtype, 2.0, 1.0)
            count = x.numel() // (shape[0] * shape[-1])
            sums = norm.gn_channel_sums(x)
            _same_bits(f"gn_stats {shape} {dtype}", sums,
                       norm.gn_channel_sums(x))
            got = norm.group_stats(*sums, shape[-1], count, 1e-5)
            want = norm.group_stats(*norm.gn_channel_sums_reference(x),
                                    shape[-1], count, 1e-5)
            err = max(_compare(f"gn_stats {shape} {what}", g, w, GN_TOL)
                      for what, g, w in zip(("mean", "inv"), got, want))
            spatial = tuple(range(1, x.ndim - 1))
            # one library call that reads x once for the same per-(n, c)
            # statistics
            fn = lambda: norm.gn_channel_sums(x)
            k_ms, p_ms, l_ms = _time_turns(
                fn, lambda: norm.gn_channel_sums_reference(x),
                lambda: torch.var_mean(x, dim=spatial, correction=0))
            # two launches a call: the partial sums and the final tree
            k_dev = _device_ms(fn, 2) if model_shape else math.nan
            work = _elementwise(x.numel(), 3, x.numel() * x.element_size()
                                + 8 * shape[0] * shape[-1])
            record("gn_stats", str(shape), dtype, err, k_ms, p_ms,
                   model_shape, *work, l_ms, k_dev)
            if model_shape:
                log(f"{'':13s} device time: kernel {_ms(k_dev)}")
                _add_sums(stats_sums, ("predictor shapes", dtype),
                          window=k_ms, device=k_dev, library=l_ms,
                          bound=_bound_ms(*work)[0])
            del x
            torch.cuda.empty_cache()
        # 3b: the ResidualUNet3D predictor's GroupNorm inputs (N=4), the
        # UNet3D training step's x_aff recompute inputs (N=1), ragged C
        cases = ([(s[1], "ResidualUNet3D") for s in affine]
                 + [(s, "UNet3D train") for s, m in train_shapes["gn"]
                    if m == "UNet3D"]
                 + [(r, "ragged") for r in ragged_gn])
        for shape, model in cases:
            x = rand(shape, dtype)
            a, b = coeffs(shape[0], shape[-1])
            err = _compare(f"gn_affine {shape}", norm.gn_affine(x, a, b),
                           norm.gn_affine_reference(x, a, b), 0.0, exact=True)
            bshape = (shape[0],) + (1,) * (x.ndim - 2) + (shape[-1],)
            # the library call moves the same bytes: coefficients in x's
            # dtype, so a bf16 x gives a bf16 y (its rounding differs)
            a_b, b_b = a.view(bshape).to(dtype), b.view(bshape).to(dtype)
            fns = (lambda: norm.gn_affine(x, a, b),
                   lambda: norm.gn_affine_reference(x, a, b),
                   lambda: torch.addcmul(b_b, x, a_b))
            k_ms, p_ms, l_ms = _time_turns(*fns)
            k_dev, l_dev = _device_ms(fns[0]), _device_ms(fns[2])
            work = _elementwise(x.numel(), 2, 2 * x.numel() * x.element_size()
                                + 8 * shape[0] * shape[-1])
            record("gn_affine", f"{shape} {model}", dtype, err, k_ms, p_ms,
                   model == "ResidualUNet3D", *work, l_ms, k_dev)
            log(f"{'':13s} device time: kernel {_ms(k_dev)}, "
                f"torch.addcmul {_ms(l_dev)}")
            if model != "ragged":
                _add_sums(affine_sums, (f"{model} shapes", dtype),
                          window=k_ms, device=k_dev, library=l_ms,
                          library_device=l_dev, bound=_bound_ms(*work)[0])
            del x
            torch.cuda.empty_cache()
        # 4: the predictors' batches (patch = stride: no overlap; the second
        # batch a padded tail), overlapping windows at predictor size, and
        # ragged ones; (pshape, volume, starts, valid, halo, (channels of
        # the network output, offset of the selected ones), label): the
        # patches are a halo-stripped channel view of the network output,
        # as the predictor passes them
        wins = _windows(OVERLAP_VOLUME, OVERLAP_PATCH, OVERLAP_STRIDE)
        cases = [(s[1], s[2], s[3], s[4], s[5], (s[1][-1], 0), "predictor")
                 for s in overlaps] + [
            ((len(wins), *OVERLAP_PATCH, 1), OVERLAP_VOLUME, wins,
             [1] * len(wins), OVERLAP_HALO, (1, 0), "overlapping windows"),
            ((5, 4, 8, 9, 2), (8, 14, 16),
             [[0, 0, 0], [2, 3, 1], [1, 5, 6], [4, 6, 7], [4, 6, 7]],
             [1, 1, 1, 1, 0], (0, 0, 0), (2, 0), "ragged"),
            ((6, 7, 9, 5, 3), (9, 11, 13),
             [[0, 0, 0], [1, 1, 1], [2, 2, 8], [2, 0, 4], [0, 2, 3], [0, 2, 3]],
             [1, 1, 1, 1, 1, 0], (0, 0, 0), (3, 0), "ragged"),
            ((5, 4, 8, 9, 1), (8, 14, 16),
             [[0, 0, 0], [2, 3, 1], [1, 5, 6], [4, 6, 7], [4, 6, 7]],
             [1, 1, 1, 1, 0], (1, 2, 1), (3, 1), "ragged view"),
            ((6, 7, 9, 5, 2), (9, 11, 13),
             [[0, 0, 0], [1, 1, 1], [2, 2, 8], [2, 0, 4], [0, 2, 3], [0, 2, 3]],
             [1, 1, 1, 1, 1, 0], (3, 1, 2), (3, 0), "ragged view"),
        ]
        for pshape, vol, starts, valid, halo, (cb, c0), label in cases:
            p_, pd, ph, pw, c = pshape
            hz, hy, hx = halo
            base = rand((p_, pd + 2 * hz, ph + 2 * hy, pw + 2 * hx, cb), dtype)
            p = base[:, hz:hz + pd, hy:hy + ph, hx:hx + pw, c0:c0 + c]
            acc0 = rand((*vol, c))
            cnt0 = torch.randint(0, 3, (*vol, c), device=DEVICE,
                                 generator=gen).float()
            acc, cnt = acc0.clone(), cnt0.clone()
            p_acc, p_cnt = acc0.clone(), cnt0.clone()
            with _sync_debug_error():  # no copy to the card, no wait for it
                overlap.overlap_add_into(acc, cnt, p, starts, valid)
            sync_checked += 1
            overlap.overlap_add_into_reference(p_acc, p_cnt, p, starts, valid)
            err = max(_compare(f"overlap_add {pshape} acc", acc, p_acc, 0.0,
                               exact=True),
                      _compare(f"overlap_add {pshape} cnt", cnt, p_cnt, 0.0,
                               exact=True))
            fn = lambda: overlap.overlap_add_into(acc, cnt, p, starts, valid)
            k_ms, p_ms = _time_turns(
                fn, lambda: overlap.overlap_add_into_reference(
                    p_acc, p_cnt, p, starts, valid))
            k_dev = _device_ms(fn, -(-p_ // overlap.CHUNK))
            flop, nbytes = _overlap_work(pshape, vol, starts, valid,
                                         p.element_size())
            record("overlap_add", f"{pshape} into {vol} {label}", dtype, err,
                   k_ms, p_ms, label == "predictor", flop, nbytes, PEAK_FP32,
                   dev_ms=k_dev)
            log(f"{'':13s} device time: kernel {_ms(k_dev)}; patches "
                f"strides {p.stride()}")
            if label != "ragged" and label != "ragged view":
                _add_sums(overlap_sums, (f"{label} case(s)", dtype),
                          window=k_ms, device=k_dev,
                          bound=_bound_ms(flop, nbytes, PEAK_FP32)[0])
            del base, p, acc0, cnt0, acc, cnt, p_acc, p_cnt
            torch.cuda.empty_cache()
    log(f"[phase 6] ok: {len(gcr)} gcr_conv3d, {len(stats)} gn_stats, "
        f"{len(affine)} gn_affine and {len(overlaps)} overlap_add model cases "
        "plus training and ragged cases match in fp32 and bf16 (gn_affine "
        "and overlap_add bit-exact, gn_stats the same bits on two calls); "
        f"overlap_add_into ran {sync_checked} times under "
        "torch.cuda.set_sync_debug_mode('error')")
    _log_sums(6, "gn_stats", stats_sums, "torch.var_mean")
    _log_sums(6, "gn_affine", affine_sums, "torch.addcmul")
    _log_sums(6, "overlap_add", overlap_sums)
    log(f"[phase 6] kernel 2 over the UNet3D predictor's "
        f"{sum(s[3] == 'UNet3D' for s in gcr)} shapes, fp32: kernel "
        f"{unet['ms']:.3f} ms, cuDNN conv3d (TF32 off) "
        f"{unet['library_ms']:.3f} ms; kernel "
        f"{_rate(unet['flop'], unet['ms'], torch.float32)}")
    return out


# ---------------------------------------------------------------------------
# 3D 'gcr' training (UNetTrainer; GroupNorm backward kernels, autograd)
# ---------------------------------------------------------------------------

TRAIN_YML = os.path.join(ROOT, "configs", "unet3d_train.yml")
TRAIN_VOLUME = (80, 260, 260)   # 1 x 2 x 2 train patches at stride 40x90x90
VAL_VOLUME = (80, 170, 340)     # 2 val patches at stride = patch
RESIDUAL_TRAIN = dict(RESIDUAL_MODEL)
RESIDUAL_PATCH = (64, 128, 128)  # bench.py's residual_unet3d row
GN_BWD_SUM_TOL = 1e-5   # Σg and Σg·x̂ over S positions: |err| <= tol · S
GRAD_TOL = 1e-3         # autograd grads vs the plain composition, relative
                        # to each gradient's max |value|
# trainer losses of steps 1, 2, 3, kernel path vs plain path, relative.
# Step 1 runs the same weights.  Adam's first updates are ±lr for every
# weight whose gradient exceeds eps, so the weights whose gradient is
# rounding noise on both paths (a GroupNorm scale whose output the next
# GroupNorm renormalizes, a conv weight of a deep level where a ReLU at its
# kink decides) move by ±lr at random; that difference grows about tenfold
# per step (measured on the H100: 0, 1.7e-5, 2.3e-4; the kernel path alone
# differs by 2.3e-5 at step 3 between two runs, as cuDNN's weight gradient
# is not deterministic).
LOSS_TOLS = (1e-5, 1e-4, 1e-3)
GRAD_NORM_TOL = 1e-4    # global grad norm after step 1 (same weights)
KINK = 1e-4             # cotangent zeroed where y is within KINK·max|y| of 0


def _training_shapes(seed: int):
    """The input shapes of every fused 'gcr' SingleConv and GroupNorm module
    of the two training models (one no-grad forward each at the training
    patch): {"gcr": [(shape, Co, model)], "gn": [(shape, model)]}."""
    import torch

    from mdeical_image_segmentation_tpu_torch.models import get_model

    cfg = read_yaml_subset(TRAIN_YML)
    patch = tuple(cfg["loaders"]["train"]["slice_builder"]["patch_shape"])
    found = {"gcr": set(), "gn": set()}
    for name, model_cfg, shape in (("UNet3D", cfg["model"], patch),
                                   ("ResidualUNet3D", RESIDUAL_TRAIN,
                                    RESIDUAL_PATCH)):
        model = get_model(model_cfg, device=DEVICE,
                          generator=None).eval()
        for p in model.parameters():
            torch.nn.init.normal_(p, std=0.02)
        shapes: set = set()
        handles = _record_shapes(model, shapes)
        with torch.no_grad():
            model(torch.zeros((1, *shape, model_cfg["in_channels"]),
                              device=DEVICE))
        for h in handles:
            h.remove()
        for s in shapes:
            if s[0] == "gcr":
                found["gcr"].add((s[1], s[2], name))
            elif s[0] == "stats":
                found["gn"].add((s[1], name))
        del model
        torch.cuda.empty_cache()
    return {k: sorted(v) for k, v in found.items()}


def phase_gn_backward_kernels(seed: int, shapes):
    """Kernels 3c and 3d against their plain versions at every GroupNorm
    input shape of the two training models, plus ragged C and C = 1, in
    fp32 and bf16, 3c also for the same bits on two calls; at the UNet3D
    shapes also by device time.  Returns {kernel: {err, ms, plain_ms,
    ...}}."""
    import torch

    from mdeical_image_segmentation_tpu_torch.ops import norm

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    out = _new_records("gn_bwd_reduce", "gn_bwd_dx")
    reduce_sums: dict = {}  # (shape set, dtype) -> summed ms and bound
    dx_sums: dict = {}

    ragged = [(2, 5, 9, 11, 3), (2, 6, 20, 17, 19), (1, 3, 7, 9, 300),
              (1, 7, 13, 11, 1)]
    # the sums cover one UNet3D training step's GroupNorm inputs
    cases = [(s, m == "UNet3D", m) for s, m in shapes["gn"]] + [
        (r, False, "ragged") for r in ragged]
    _record_header()
    for dtype in (torch.float32, torch.bfloat16):
        for shape, model_shape, model in cases:
            n, c = shape[0], shape[-1]
            count = 1
            for d in shape[1:-1]:
                count *= d
            x = _rand(gen, shape, dtype, 2.0, 1.0)
            g = _rand(gen, shape, dtype)
            mean = 0.3 * torch.randn((n, c), device=DEVICE, generator=gen) + 1
            inv = torch.rand((n, c), device=DEVICE, generator=gen) + 0.5
            got = norm.gn_bwd_reduce(x, g, mean, inv)
            _same_bits(f"gn_bwd_reduce {shape} {dtype}", got,
                       norm.gn_bwd_reduce(x, g, mean, inv))
            want = norm.gn_bwd_reduce_reference(x, g, mean, inv)
            err = 0.0
            for what, a, b in zip(("sum g", "sum g*xhat"), got, want):
                e = (a - b).abs().max().item()
                if not torch.isfinite(a).all() or e > GN_BWD_SUM_TOL * count:
                    raise AssertionError(
                        f"gn_bwd_reduce {shape} {dtype} {what}: differs from "
                        f"the plain version by {e:.3e} (limit "
                        f"{GN_BWD_SUM_TOL} x {count} positions)")
                err = max(err, e)
            fn = lambda: norm.gn_bwd_reduce(x, g, mean, inv)
            k_ms, p_ms = _time_turns(
                fn, lambda: norm.gn_bwd_reduce_reference(x, g, mean, inv))
            timed = model == "UNet3D"
            # two launches a call: the partial sums and the final tree
            k_dev = _device_ms(fn, 2) if timed else math.nan
            work = _elementwise(x.numel(), 5, 2 * x.numel() * x.element_size()
                                + 16 * n * c)
            _record(out, "gn_bwd_reduce", f"{shape} {model}", dtype, err,
                    k_ms, p_ms, model_shape, *work, dev_ms=k_dev)
            if timed:
                log(f"{'':13s} device time: kernel {_ms(k_dev)}")
                _add_sums(reduce_sums, ("UNet3D training shapes", dtype),
                          window=k_ms, device=k_dev,
                          bound=_bound_ms(*work)[0])
            a, cc, dd = (torch.randn((n, c), device=DEVICE, generator=gen)
                         for _ in range(3))
            err = _compare(f"gn_bwd_dx {shape}", norm.gn_bwd_dx(x, g, a, cc, dd),
                           norm.gn_bwd_dx_reference(x, g, a, cc, dd),
                           BF16_TOL if dtype == torch.bfloat16
                           else AFFINE_FP32_TOL)
            fn = lambda: norm.gn_bwd_dx(x, g, a, cc, dd)
            k_ms, p_ms = _time_turns(
                fn, lambda: norm.gn_bwd_dx_reference(x, g, a, cc, dd))
            k_dev = _device_ms(fn) if timed else math.nan
            work = _elementwise(x.numel(), 4, 3 * x.numel() * x.element_size()
                                + 12 * n * c)
            _record(out, "gn_bwd_dx", f"{shape} {model}", dtype, err, k_ms,
                    p_ms, model_shape, *work, dev_ms=k_dev)
            if timed:
                log(f"{'':13s} device time: kernel {_ms(k_dev)}")
                _add_sums(dx_sums, ("UNet3D training shapes", dtype),
                          window=k_ms, device=k_dev,
                          bound=_bound_ms(*work)[0])
            del x, g
            torch.cuda.empty_cache()
    log(f"[phase 7] ok: {len(shapes['gn'])} model shapes plus "
        f"{len(ragged)} ragged cases match in fp32 and bf16 (gn_bwd_reduce "
        "the same bits on two calls)")
    _log_sums(7, "gn_bwd_reduce", reduce_sums)
    _log_sums(7, "gn_bwd_dx", dx_sums)
    return out


def _rel_errs(names, got, want):
    """max |got - want| / max |want| per gradient."""
    import torch

    errs = {}
    for name, a, b in zip(names, got, want):
        if not torch.isfinite(a).all():
            raise AssertionError(f"non-finite {name}")
        errs[name] = ((a.float() - b.float()).abs().max()
                      / b.float().abs().max().clamp_min(1e-30)).item()
    return errs


def phase_train_forward_convs(seed: int, shapes):
    """Kernel 2 against cuDNN's conv3d (fp32, TF32 off) at the UNet3D
    training model's 14 SingleConv input shapes (N=1, 80x170x170): the
    forward convs of one training step.  Returns (kernel ms, cuDNN ms),
    summed."""
    import torch
    import torch.nn.functional as F

    from mdeical_image_segmentation_tpu_torch.ops import fused_conv

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    ms = lib_ms = flop_sum = 0.0
    cases = [(s, co) for s, co, m in shapes["gcr"] if m == "UNet3D"]
    for shape, co in cases:
        ci = shape[-1]
        x = _rand(gen, shape, torch.float32)
        k = _rand(gen, (3, 3, 3, ci, co), torch.float32, (27 * ci) ** -0.5)
        a = torch.rand((shape[0], ci), device=DEVICE, generator=gen) + 0.5
        b = 0.5 * torch.randn((shape[0], ci), device=DEVICE, generator=gen)
        # N=1 picks its own tiles: held against the plain version here too
        err = _compare(f"gcr_conv3d train {shape}->{co}",
                       fused_conv.fused_conv3d(x, k, a, b),
                       fused_conv.fused_conv3d_reference(x, k, a, b), FP32_TOL)
        xc, kc = x.permute(0, 4, 1, 2, 3), k.permute(4, 3, 0, 1, 2)
        k_ms, l_ms = _time_turns(
            lambda: fused_conv.fused_conv3d(x, k, a, b),
            lambda: F.conv3d(xc, kc, padding=1))
        flop = _gcr_flop_bytes(shape, co, 3, 4)[0]
        ms += k_ms
        lib_ms += l_ms
        flop_sum += flop
        log(f"  train fwd {str(shape):26s} -> {co:4d}: err {err:.2e}; kernel "
            f"{k_ms:9.3f} ms {_rate(flop, k_ms, torch.float32)}; cuDNN "
            f"{l_ms:9.3f} ms")
        del x, k, xc, kc
        torch.cuda.empty_cache()
    log(f"[phase 8] kernel 2 at the {len(cases)} training-forward shapes, "
        f"fp32: kernel {ms:.3f} ms, cuDNN conv3d (TF32 off) {lib_ms:.3f} ms; "
        f"kernel {_rate(flop_sum, ms, torch.float32)}")
    return ms, lib_ms


def phase_autograd(seed: int, shapes):
    """Gradients through the autograd Functions against autograd through
    the plain composition (affine, F.conv3d, ReLU; F.group_norm), fp32 with
    TF32 off, at the training models' shapes."""
    import torch
    import torch.nn.functional as F

    from mdeical_image_segmentation_tpu_torch.ops import fused_conv, norm

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    worst = 0.0

    def randn(shape, scale=1.0, shift=0.0):
        return torch.randn(shape, device=DEVICE, generator=gen) * scale + shift

    def plain_gn(x, s, b, groups):
        xc = x.permute(0, 4, 1, 2, 3)
        return F.group_norm(xc, groups, s, b, 1e-5).permute(0, 2, 3, 4, 1)

    log(f"{'block':8s} {'x shape':26s} {'Co':>4s} {'kd':>2s} "
        f"{'dx':>9s} {'dscale':>9s} {'dbias':>9s} {'dw':>9s} "
        f"{'kernel ms':>10s} {'plain ms':>9s}")
    cases = [(s, co, kd) for s, co, m in shapes["gcr"] if m == "UNet3D"
             for kd in (3, 1)]
    for shape, co, kd in cases:
        ci = shape[-1]
        groups = 1 if ci < 8 else 8
        x = randn(shape, 1.0, 0.3).requires_grad_()
        s = randn((ci,), 0.2, 1.0).requires_grad_()
        b = randn((ci,), 0.1).requires_grad_()
        k = randn((kd, 3, 3, ci, co), (9 * kd * ci) ** -0.5).requires_grad_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = fused_conv.gcr_fused_conv(x, s, b, k, groups, 1e-5)
        torch.cuda.synchronize()
        k_ms = (time.perf_counter() - t0) * 1e3
        with torch.no_grad():
            y_plain = F.relu(F.conv3d(
                plain_gn(x, s, b, groups).permute(0, 4, 1, 2, 3),
                k.permute(4, 3, 0, 1, 2), padding=((kd - 1) // 2, 1, 1))
            ).permute(0, 2, 3, 4, 1)
            # the ReLU's choice at its kink is not a gradient: zero the
            # cotangent where either output lies within KINK·max|y| of 0
            lim = KINK * y_plain.abs().max()
            near = ((y > 0) & (y < lim)) | ((y_plain > 0) & (y_plain < lim))
            w = randn(y.shape).masked_fill_(near, 0.0)
            del y_plain
        t0 = time.perf_counter()
        got = torch.autograd.grad(y, (x, s, b, k), w)
        torch.cuda.synchronize()
        k_ms += (time.perf_counter() - t0) * 1e3
        del y
        t0 = time.perf_counter()
        y = F.relu(F.conv3d(plain_gn(x, s, b, groups).permute(0, 4, 1, 2, 3),
                            k.permute(4, 3, 0, 1, 2),
                            padding=((kd - 1) // 2, 1, 1))
                   ).permute(0, 2, 3, 4, 1)
        want = torch.autograd.grad(y, (x, s, b, k), w)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        errs = _rel_errs(("dx", "dscale", "dbias", "dw"), got, want)
        log(f"{'gcr':8s} {str(shape):26s} {co:4d} {kd:2d} {errs['dx']:9.2e} "
            f"{errs['dscale']:9.2e} {errs['dbias']:9.2e} {errs['dw']:9.2e} "
            f"{k_ms:10.1f} {p_ms:9.1f}  near-kink share "
            f"{near.float().mean().item():.2e}")
        worst = max(worst, *errs.values())
        if max(errs.values()) > GRAD_TOL:
            raise AssertionError(f"gcr_fused_conv {shape}->{co} kd{kd}: "
                                 f"grads differ from the plain composition "
                                 f"{errs} (limit {GRAD_TOL} x max |grad|)")
        del x, s, b, k, y, w, got, want, near
        torch.cuda.empty_cache()
    gn_cases = [(sh, m) for sh, m in shapes["gn"]
                if m == "ResidualUNet3D"] + [((1, 7, 13, 11, 1), "ragged"),
                                             ((2, 6, 20, 17, 24), "ragged")]
    for shape, model in gn_cases:
        c = shape[-1]
        groups = 1 if c < 8 else 8
        mod = norm.GroupNorm(c, groups, device=DEVICE)
        with torch.no_grad():
            mod.weight.copy_(randn((c,), 0.2, 1.0))
            mod.bias.copy_(randn((c,), 0.1))
        x = randn(shape, 2.0, 1.0).requires_grad_()
        w = randn(shape)
        got = torch.autograd.grad(mod(x), (x, mod.weight, mod.bias), w)
        want = torch.autograd.grad(plain_gn(x, mod.weight, mod.bias, groups),
                                   (x, mod.weight, mod.bias), w)
        errs = _rel_errs(("dx", "dscale", "dbias"), got, want)
        log(f"{'GN':8s} {str(shape):26s} {'':4s} {'':2s} {errs['dx']:9.2e} "
            f"{errs['dscale']:9.2e} {errs['dbias']:9.2e}  ({model})")
        worst = max(worst, *errs.values())
        if max(errs.values()) > GRAD_TOL:
            raise AssertionError(f"GroupNorm {shape}: grads differ from "
                                 f"F.group_norm's {errs} (limit {GRAD_TOL})")
        del x, w, got, want
        torch.cuda.empty_cache()
    log(f"[phase 8] ok: {len(cases)} gcr_fused_conv and {len(gn_cases)} "
        f"GroupNorm cases; worst gradient error {worst:.3e} of max |grad| "
        f"(limit {GRAD_TOL}; TF32 off on both paths)")
    return worst


def _smoothed(raw):
    """A 9-wide moving average of the volume along each axis (float64)."""
    import numpy as np

    v = raw.astype(np.float64)
    for axis in range(3):
        c = np.cumsum(np.pad(v, [(5, 4) if a == axis else (0, 0)
                                 for a in range(3)], mode="edge"), axis=axis)
        n = v.shape[axis]
        v = (np.take(c, range(9, 9 + n), axis=axis)
             - np.take(c, range(0, n), axis=axis)) / 9.0
    return v


def _smooth_label(raw):
    """A binary label with blobs: the smoothed volume thresholded at 0."""
    import numpy as np

    return (_smoothed(raw) > 0).astype(np.float32)


class _PatchDataset:
    """(raw, label) patches of in-memory volumes, channels-last (D, H, W, 1)
    float32, as the JAX package's ToTensor(expand_dims) gives them."""

    def __init__(self, raw, label, patch, stride):
        from mdeical_image_segmentation_tpu_torch.data.slice_builder import (
            SliceBuilder,
        )

        sb = SliceBuilder(raw, label, None, patch, stride)
        self.raw, self.label = raw, label
        self.slices = list(zip(sb.raw_slices, sb.label_slices))

    def __len__(self):
        return len(self.slices)

    def __getitem__(self, i):
        rs, ls = self.slices[i]
        return self.raw[rs][..., None], self.label[ls][..., None]


def _instrument(trainer, rec):
    """Wrap the trainer's step: synchronised ms, launch counts, the loss
    and (on the first step) the global grad norm."""
    import torch

    orig = trainer._train_step

    def step(input, target, weight):
        torch.cuda.synchronize()
        before, t0 = _counts(), time.perf_counter()
        loss, output = orig(input, target, weight)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = _counts()
        norm2 = grads = None
        if not rec:
            named = [(n, p) for n, p in trainer.model.named_parameters()
                     if p.grad is not None]
            norm2 = torch.sqrt(sum(p.grad.double().square().sum()
                                   for _, p in named)).item()
            grads = {n: p.grad.detach().cpu() for n, p in named}
        rec.append({"ms": ms, "loss": loss.item(), "grad_norm": norm2,
                    "grads": grads,
                    "launches": {k: after[k] - before[k] for k in after}})
        return loss, output

    trainer._train_step = step


def _make_trainer(model_cfg, cfg, loaders, checkpoint_dir, pre_trained,
                  seed=SEED, **trainer_kw):
    from mdeical_image_segmentation_tpu_torch.logging_utils import (
        get_tensorboard_formatter,
    )
    from mdeical_image_segmentation_tpu_torch.losses import (
        get_loss_criterion,
    )
    from mdeical_image_segmentation_tpu_torch.metrics import (
        get_evaluation_metric,
    )
    from mdeical_image_segmentation_tpu_torch.models import get_model
    from mdeical_image_segmentation_tpu_torch.train.optimizers import (
        create_lr_scheduler,
        create_optimizer,
    )
    from mdeical_image_segmentation_tpu_torch.train.trainer3d import (
        UNetTrainer,
    )

    model = get_model(model_cfg, device=DEVICE)
    optimizer = create_optimizer(cfg["optimizer"], model.parameters())
    lr = cfg["optimizer"]["learning_rate"]
    return UNetTrainer(
        model=model, optimizer=optimizer,
        lr_scheduler=create_lr_scheduler(cfg["lr_scheduler"], lr),
        loss_criterion=get_loss_criterion(cfg),
        eval_criterion=get_evaluation_metric(cfg), loaders=loaders,
        checkpoint_dir=checkpoint_dir, base_lr=lr, seed=seed,
        tensorboard_formatter=get_tensorboard_formatter(None),
        pre_trained=pre_trained, max_num_epochs=100,
        **{**{k: v for k, v in cfg["trainer"].items()
              if k == "eval_score_higher_is_better"}, **trainer_kw})


def _initial_checkpoint(model_cfg, seed, workdir, name):
    """Random weights from a seeded generator, written with the port's
    save_checkpoint: the trainers' ``pre_trained``."""
    import torch

    from mdeical_image_segmentation_tpu_torch.models import get_model
    from mdeical_image_segmentation_tpu_torch.train import save_checkpoint
    from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
        state_dict_to_flax,
    )

    model = get_model(model_cfg, generator=torch.Generator().manual_seed(seed))
    return save_checkpoint(
        {"model_state_dict": state_dict_to_flax(model.state_dict()),
         "best_eval_score": 0.0, "num_iterations": 0},
        False, os.path.join(workdir, name))


class UNet3DTraining:
    """Phase 9's training setup, the one way to build it (phase 9 and
    ``chip_train_step.py`` use it): the UNet3D, loss, metric, optimizer and
    scheduler of configs/unet3d_train.yml; a seeded 80x260x260 training
    volume (4 patches at the yml's stride) and 80x170x340 validation volume
    (2 patches), each labelled with its smoothed sign; random initial
    weights from ``seed``, saved under ``workdir``.  ``trainer(name)``
    builds a UNetTrainer on them, writing to ``workdir/name``; inside
    ``plain_path()`` it runs the plain versions."""

    def __init__(self, seed: int, workdir: str):
        self.seed, self.workdir = seed, workdir
        os.makedirs(workdir, exist_ok=True)
        self.cfg = read_yaml_subset(TRAIN_YML)
        self.model_cfg = self.cfg["model"]
        loaders = self.cfg["loaders"]
        train_sb = loaders["train"]["slice_builder"]
        val_sb = loaders["val"]["slice_builder"]
        raw = seeded_volume(TRAIN_VOLUME, seed + 2)
        val_raw = seeded_volume(VAL_VOLUME, seed + 3)
        self.train_ds = _PatchDataset(raw, _smooth_label(raw),
                                      train_sb["patch_shape"],
                                      train_sb["stride_shape"])
        self.val_ds = _PatchDataset(val_raw, _smooth_label(val_raw),
                                    val_sb["patch_shape"],
                                    val_sb["stride_shape"])
        self.batch_size = loaders["batch_size"]
        self.checkpoint = _initial_checkpoint(self.model_cfg, seed, workdir,
                                              "unet3d_init")

    def trainer(self, name: str, resume: str | None = None, **trainer_kw):
        """A UNetTrainer from the initial weights, or from ``resume``."""
        from mdeical_image_segmentation_tpu_torch.data.loaders import (
            VolumeLoader,
        )

        loaders = {"train": VolumeLoader(self.train_ds, self.batch_size,
                                         shuffle=True, seed=self.seed,
                                         drop_last=True),
                   "val": VolumeLoader(self.val_ds, self.batch_size)}
        if resume is not None:
            trainer_kw["resume"] = resume
        return _make_trainer(self.model_cfg, self.cfg, loaders,
                             os.path.join(self.workdir, name),
                             None if resume else self.checkpoint,
                             seed=self.seed, **trainer_kw)


def _compare_runs(name, rec, plain_rec, steps, loss_tols=LOSS_TOLS,
                  norm_tol=GRAD_NORM_TOL):
    """Losses of the first ``steps`` steps, the global grad norm after step
    1 and each parameter's step-1 gradient, kernel path vs plain path."""
    bad = []
    for i in range(steps):
        k, p = rec[i]["loss"], plain_rec[i]["loss"]
        rel = abs(k - p) / abs(p)
        log(f"  step {i + 1}: loss kernel {k:.7f} plain {p:.7f} (rel "
            f"{rel:.2e}, limit {loss_tols[i]}); ms kernel "
            f"{rec[i]['ms']:.1f} plain {plain_rec[i]['ms']:.1f}")
        if rel > loss_tols[i]:
            bad.append(f"step {i + 1} loss {rel:.2e}")
    gk, gp = rec[0]["grad_norm"], plain_rec[0]["grad_norm"]
    norm_err = abs(gk - gp) / gp
    log(f"  global grad norm after step 1: kernel {gk:.7e} plain {gp:.7e} "
        f"(rel {norm_err:.2e}, limit {norm_tol})")
    per_param = sorted(
        ((float((g - plain_rec[0]["grads"][n]).abs().max()
                / plain_rec[0]["grads"][n].abs().max().clamp_min(1e-30)), n)
         for n, g in rec[0]["grads"].items()), reverse=True)
    log(f"  step-1 gradients, max |kernel - plain| / max |plain| per "
        f"parameter, worst 4 of {len(per_param)}: "
        + ", ".join(f"{n} {e:.2e}" for e, n in per_param[:4]))
    if norm_err > norm_tol:
        bad.append(f"grad norm {norm_err:.2e}")
    if bad:
        raise AssertionError(f"{name}, kernel path vs plain path: "
                             f"{'; '.join(bad)} beyond the limits")


def phase_train_unet3d(seed: int, workdir: str):
    """UNet3D of configs/unet3d_train.yml at full width through
    UNetTrainer.fit(); returns the main-path launches."""
    import numpy as np
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    setup = UNet3DTraining(seed, workdir)
    cfg, model_cfg = setup.cfg, setup.model_cfg
    train_sb = cfg["loaders"]["train"]["slice_builder"]
    log(f"[phase 9] model {model_cfg}; loss {cfg['loss']}; eval_metric "
        f"{cfg['eval_metric']}; optimizer {cfg['optimizer']}; lr_scheduler "
        f"{cfg['lr_scheduler']}; batch {setup.batch_size}; "
        f"patch {train_sb['patch_shape']}, train stride "
        f"{train_sb['stride_shape']}; fp32, TF32 off")
    log(f"  {len(setup.train_ds)} train patches of a {TRAIN_VOLUME} volume, "
        f"{len(setup.val_ds)} val patches of {VAL_VOLUME}; label share "
        f"{setup.train_ds.label.mean():.3f}")
    run_dir = os.path.join(workdir, "unet3d_train")
    trainer = setup.trainer("unet3d_train", max_num_iterations=6,
                            validate_after_iters=3, log_after_iters=2)
    rec = []
    _instrument(trainer, rec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    trainer.fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    # two SingleConvs per encoder and decoder, 14 at 4 levels; the first
    # one's input (the image) needs no gradient, so 3d runs one time less
    convs = 2 * (2 * model_cfg["num_levels"] - 1)
    want = {"gcr_conv3d": convs, "gn_stats": convs, "gn_affine": convs,
            "gn_bwd_reduce": convs, "gn_bwd_dx": convs - 1, "overlap_add": 0}
    for i, r in enumerate(rec):
        log(f"  step {i + 1}: {r['ms']:.1f} ms, loss {r['loss']:.6f}, "
            f"launches {r['launches']}")
        if r["launches"] != want or not np.isfinite(r["loss"]):
            raise AssertionError(f"step {i + 1}: {r}, want launches {want} "
                                 "and a finite loss")
    last = os.path.join(run_dir, "last_checkpoint.msgpack")
    best = os.path.join(run_dir, "best_checkpoint.msgpack")
    if not (os.path.exists(last) and os.path.exists(best)):
        raise AssertionError("the last and best checkpoints were not written")
    if trainer.num_iterations != 7 or len(rec) != 7:
        raise AssertionError(f"{len(rec)} steps, iteration "
                             f"{trainer.num_iterations}: want 7 and 7")
    steady = statistics.median(r["ms"] for r in rec[1:])
    log(f"  fit: {len(rec)} steps + 2 validations in {wall:.2f} s; step "
        f"median {steady:.1f} ms (first {rec[0]['ms']:.1f}); peak memory "
        f"{peak:.2f} GiB; best score {trainer.best_eval_score:.4f}; "
        f"launches {launches}")

    # the same first three steps from the same weights on the plain path
    with plain_path():
        plain = setup.trainer("unet3d_plain", max_num_iterations=2,
                              validate_after_iters=1000, log_after_iters=1000)
        plain_rec = []
        _instrument(plain, plain_rec)
        torch.cuda.reset_peak_memory_stats()
        plain.fit()
        plain_peak = torch.cuda.max_memory_allocated() / 2**30
    del plain
    torch.cuda.empty_cache()
    _compare_runs("UNet3D", rec, plain_rec, 3)
    plain_steady = statistics.median(r["ms"] for r in plain_rec[1:])
    log(f"  plain path: step median {plain_steady:.1f} ms, peak memory "
        f"{plain_peak:.2f} GiB")

    # resume from the last checkpoint (saved at iteration 6) for one step
    resumed = setup.trainer("unet3d_train", resume=last, max_num_iterations=5,
                            validate_after_iters=1000, log_after_iters=1000)
    if resumed.num_iterations != 6:
        raise AssertionError(f"resumed at iteration {resumed.num_iterations}"
                             ", want 6")
    res_rec = []
    _instrument(resumed, res_rec)
    resumed.fit()
    p0 = next(resumed.model.parameters())
    adam_step = int(resumed.optimizer.state[p0]["step"])
    log(f"  resume: iteration 6 -> {resumed.num_iterations}, one step, loss "
        f"{res_rec[0]['loss']:.6f}, Adam step {adam_step}")
    if (len(res_rec) != 1 or adam_step != 7
            or not np.isfinite(res_rec[0]["loss"])):
        raise AssertionError(f"resume took {len(res_rec)} steps, Adam step "
                             f"{adam_step}: want 1 step and Adam step 7")
    del trainer, resumed
    torch.cuda.empty_cache()
    return launches, steady, plain_steady, peak


def phase_train_residual(seed: int, workdir: str):
    """ResidualUNet3D f_maps 32, 5 levels at 64x128x128 for two steps, with
    its loss and grad norm against the plain path: the GroupNorm module's
    Function (3a/3b forward, 3c/3d backward) beside the fused one."""
    import numpy as np
    import torch

    from mdeical_image_segmentation_tpu_torch.data.loaders import VolumeLoader

    cfg = read_yaml_subset(TRAIN_YML)
    raw = seeded_volume((64, 128, 256), seed + 4)
    ds = _PatchDataset(raw, _smooth_label(raw), RESIDUAL_PATCH,
                       RESIDUAL_PATCH)

    def loaders():
        return {"train": VolumeLoader(ds, 1, shuffle=True, seed=seed,
                                      drop_last=True),
                "val": VolumeLoader(ds, 1)}

    ckpt0 = _initial_checkpoint(RESIDUAL_TRAIN, seed + 1, workdir,
                                "residual_init")
    kw = dict(max_num_iterations=1, validate_after_iters=1000,
              log_after_iters=1000)
    trainer = _make_trainer(RESIDUAL_TRAIN, cfg, loaders(),
                            os.path.join(workdir, "residual"), ckpt0, **kw)
    rec = []
    _instrument(trainer, rec)
    _zero_counts()
    trainer.fit()
    launches = _counts()
    blocks = 2 * RESIDUAL_TRAIN["num_levels"] - 1
    want = {"gcr_conv3d": blocks, "gn_stats": 2 * blocks,
            "gn_affine": 2 * blocks, "gn_bwd_reduce": 2 * blocks,
            "gn_bwd_dx": 2 * blocks, "overlap_add": 0}
    for i, r in enumerate(rec):
        log(f"  step {i + 1}: {r['ms']:.1f} ms, loss {r['loss']:.6f}, "
            f"launches {r['launches']}")
        if r["launches"] != want or not np.isfinite(r["loss"]):
            raise AssertionError(f"step {i + 1}: {r}, want {want}")
    with plain_path():
        plain = _make_trainer(RESIDUAL_TRAIN, cfg, loaders(),
                              os.path.join(workdir, "residual_plain"), ckpt0,
                              **kw)
        plain_rec = []
        _instrument(plain, plain_rec)
        plain.fit()
    _compare_runs("ResidualUNet3D", rec, plain_rec, 2)
    del trainer, plain
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# 2D classic-UNet training (Trainer.train(); kernel 1 under double_conv2d)
# ---------------------------------------------------------------------------

TRAIN_BATCH_2D = 32          # bench.py's headline batch
TRAIN_STEPS_2D = 10
# 2D step losses of steps 1, 2, 3 and the step-1 grad norm, kernel path vs
# plain path, relative, in bf16.  Set before any run: bf16 keeps 8 bits, so
# a conv output that the two paths round differently differs by one ulp
# (2^-8 = 3.9e-3 relative); the loss, a mean over 2M pixels, averages such
# differences, so step 1 (same weights) should sit well inside half an ulp;
# AdamW's first updates are ±lr for every weight, and a weight whose bf16
# gradient is rounding noise moves either way, so the gap grows step by
# step (about tenfold a step in fp32, phase 9).  fp32 keeps LOSS_TOLS.
BF16_LOSS_TOLS = (2e-3, 1e-2, 5e-2)
BF16_GRAD_NORM_TOL = 1e-2
DC_GRAD_TOL = {"float32": 1e-3, "bfloat16": 2e-2}  # of each max |grad|
CONV_CORE = re.compile(r"conv_(halo|gather)_kernel")
CUDNN = re.compile(r"cudnn|xmma|dgrad|wgrad|fprop|implicit|gemm|cutlass|"
                   r"sm90_|sm80_|nchwToNhwc|nhwcToNchw", re.I)


def _plain_double_conv(x, w1, b1, w2, b2):
    """DoubleConvolution as two F.conv2d + bias + relu, differentiated by
    autograd: the plain composition, with kernel 1's arithmetic: each conv
    and its bias in fp32 from the inputs as they are, z and y rounded to
    x's dtype after the ReLU (cuDNN's bf16 conv would round the conv before
    adding the bias, moving the ReLU masks by an ulp).  Returns (y, z)."""
    import torch.nn.functional as F

    def conv(t, w, b):
        return F.conv2d(t.float().permute(0, 3, 1, 2),
                        w.float().permute(3, 2, 0, 1), b.float(),
                        padding=1).permute(0, 2, 3, 1)

    z = F.relu(conv(x, w1, b1)).to(x.dtype)
    return F.relu(conv(z, w2, b2)).to(x.dtype), z


def phase_dc_training_batch(seed: int):
    """Kernel 1 at the training batch (N = 32, bf16, z written, as the
    train step calls it): y and z against the plain version, timed against
    the cuDNN pair, device time; then ``double_conv2d``'s gradients at the
    9 DoubleConv shapes, fp32 (TF32 off) and bf16, against autograd through
    the plain composition, and the raw wrapper's refusal under grad.
    Returns the kernel-1 training-batch record."""
    import torch
    import torch.nn.functional as F

    from mdeical_image_segmentation_tpu_torch.ops.fused_conv import (
        double_conv2d,
        fused_double2d,
        fused_double2d_reference,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    rec = {"ms": 0.0, "plain_ms": 0.0, "device_ms": 0.0, "bound_ms": 0.0,
           "max_abs_err": 0.0}
    log(f"{'case':6s} {'N,H,W,Ci,C1,Co':30s} {'err y':>9s} {'err z':>9s} "
        f"{'kernel ms':>10s} {'cuDNN ms':>9s} {'device ms':>10s}  rate")
    for name, shape in DC_SHAPES:
        shape = (TRAIN_BATCH_2D, *shape[1:])
        args = _inputs(shape, torch.bfloat16, gen)
        y, z = fused_double2d(*args)
        y_ref, z_ref = fused_double2d_reference(*args)
        errs = []
        for what, got, want in (("y", y, y_ref), ("z", z, z_ref)):
            got, want = got.float(), want.float()
            errs.append((got - want).abs().max().item())
            if (not torch.isfinite(got).all()
                    or not torch.allclose(got, want, rtol=BF16_TOL,
                                          atol=BF16_TOL)):
                raise AssertionError(f"{name} bf16 N={shape[0]}: {what} "
                                     f"differs from the plain version by "
                                     f"{errs[-1]:.3e} (rtol = atol = "
                                     f"{BF16_TOL})")
        del y, z, y_ref, z_ref
        k_ms, p_ms = _time_turns(lambda: fused_double2d(*args),
                                 lambda: fused_double2d_reference(*args))
        d_ms = _device_ms(lambda: fused_double2d(*args), launches=2)
        flop, nbytes = _dc_flop_bytes(shape, 2, with_z=True)
        for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("device_ms", d_ms),
                       ("bound_ms", _bound_ms(flop, nbytes, PEAK_BF16)[0])):
            rec[key] += v
        rec["max_abs_err"] = max(rec["max_abs_err"], *errs)
        log(f"{name:6s} {str(shape):30s} {errs[0]:9.2e} {errs[1]:9.2e} "
            f"{k_ms:10.4f} {p_ms:9.4f} {_ms(d_ms):>10s}  "
            f"{_rate(flop, k_ms, torch.bfloat16)}")
        del args
    log(f"[phase 11] kernel 1 at the training batch (N={TRAIN_BATCH_2D}, "
        f"bf16, z written) over the 9 UNet shapes: window {rec['ms']:.4f} ms,"
        f" device {_ms(rec['device_ms'])}, cuDNN pair {rec['plain_ms']:.4f} "
        f"ms, bound {rec['bound_ms']:.4f} ms (operations); share window "
        f"{_share(rec['bound_ms'], rec['ms'])}, device "
        f"{_share(rec['bound_ms'], rec['device_ms'])}")

    names = ("dx", "dw1", "db1", "dw2", "db2")
    worst = {}
    log(f"{'case':6s} {'dtype':9s} " + " ".join(f"{n:>9s}" for n in names)
        + "  zeroed share")
    for dtype in (torch.float32, torch.bfloat16):
        tol = DC_GRAD_TOL[str(dtype)[6:]]
        worst[dtype] = 0.0
        for name, shape in DC_SHAPES:
            shape = (TRAIN_BATCH_2D, *shape[1:])
            args = [t.requires_grad_() for t in _inputs(shape, dtype, gen)]
            try:
                fused_double2d(*args)
            except RuntimeError as e:
                if "double_conv2d" not in str(e):
                    raise
            else:
                raise AssertionError("the raw fused_double2d ran on tensors "
                                     "that require grad")
            y = double_conv2d(*args)
            with torch.no_grad():
                _, z = fused_double2d(*args)
                y_ref, z_ref = _plain_double_conv(*args)
                # the ReLU's choice at its kink is not a gradient: zero the
                # cotangent where the two y differ in sign or either lies
                # within KINK·max|y| of 0, and around every position where
                # the two z differ in sign (zero cotangent over its 3x3
                # window makes dz there 0, so conv1's mask decides nothing)
                lim = KINK * y_ref.abs().max()
                near = (((y > 0) != (y_ref > 0)) | ((y > 0) & (y < lim))
                        | ((y_ref > 0) & (y_ref < lim)))
                flip = ((z > 0) != (z_ref > 0)).any(-1, keepdim=True)
                flip = F.max_pool2d(flip.float().permute(0, 3, 1, 2), 3, 1,
                                    1).permute(0, 2, 3, 1) > 0
                zero = near | flip
                if zero.float().mean().item() > 0.1:
                    raise AssertionError(f"{name} {dtype}: the masks differ "
                                         "at over 10% of the outputs")
                g = torch.randn(y.shape, device="cuda", generator=gen).to(
                    dtype).masked_fill_(zero, 0.0)
                del y_ref, z_ref, z
            got = torch.autograd.grad(y, args, g)
            del y
            want = torch.autograd.grad(_plain_double_conv(*args)[0], args, g)
            errs = _rel_errs(names, got, want)
            log(f"{name:6s} {str(dtype)[6:]:9s} "
                + " ".join(f"{errs[n]:9.2e}" for n in names)
                + f"  {zero.float().mean().item():.2e}")
            worst[dtype] = max(worst[dtype], *errs.values())
            if max(errs.values()) > tol:
                raise AssertionError(
                    f"double_conv2d {name} {dtype}: gradients differ from the "
                    f"plain composition {errs} (limit {tol} x max |grad|)")
            del args, got, want, g, zero, near, flip
            torch.cuda.empty_cache()
    log(f"[phase 11] double_conv2d gradients at the 9 DoubleConv shapes, "
        f"N={TRAIN_BATCH_2D}: worst {worst[torch.float32]:.3e} (fp32, TF32 "
        f"off, limit {DC_GRAD_TOL['float32']}), {worst[torch.bfloat16]:.3e} "
        f"(bf16, limit {DC_GRAD_TOL['bfloat16']}) of max |grad|; the raw "
        f"wrapper raises under grad")
    rec["grad_err"] = max(worst.values())
    return rec


class UNet2DTraining:
    """The 2D training setup of phases 11 and 12, the one way to build it:
    a ``unet_type`` model (the base-64 UNet, or the UNet-3+ family at its
    fixed widths) with ``channels`` in and 1 out and weights from ``seed``,
    ``SyntheticSliceDataset(n_train, resolution, channels)`` to train on and
    ``n_eval`` more slices to evaluate, ``batch`` per step, AdamW at
    ``learning_rate``, the other ``TrainingArguments`` at their defaults
    unless given.  Phase 11: the UNet at 256², 1 channel, batch 32, 1e-3
    (bench.py's row); phase 12: UNet-3+ at 512², 3 channels, batch 5,
    5e-3 (``scripts/train.sh``)."""

    def __init__(self, seed: int, workdir: str, unet_type: str = "UNet",
                 resolution: int = 256, channels: int = 1,
                 n_train: int = 64, n_eval: int = 40,
                 batch: int = TRAIN_BATCH_2D, learning_rate: float = 1e-3):
        from mdeical_image_segmentation_tpu_torch.data import (
            SyntheticSliceDataset,
        )

        self.seed, self.workdir = seed, workdir
        self.unet_type, self.batch = unet_type, batch
        self.channels, self.learning_rate = channels, learning_rate
        self.train_ds = SyntheticSliceDataset(n_train, resolution, channels,
                                              seed=seed)
        self.eval_ds = (SyntheticSliceDataset(n_eval, resolution, channels,
                                              seed=seed + 7)
                        if n_eval else None)

    def model(self, compute_dtype: str = "bfloat16", device: str = "cuda",
              remat: bool = False, remat_policy=None):
        import torch

        from mdeical_image_segmentation_tpu_torch.models import (
            UNetConfig,
            UNetModel,
        )

        return UNetModel(
            UNetConfig(in_channels=self.channels, out_channels=1,
                       unet_type=self.unet_type, base_features=64,
                       compute_dtype=compute_dtype, remat=remat,
                       remat_policy=remat_policy),
            device=device, generator=torch.Generator().manual_seed(self.seed))

    def trainer(self, name: str, compute_dtype: str = "bfloat16",
                device: str = "cuda", remat: bool = False,
                remat_policy=None, mesh=None, **kw):
        from mdeical_image_segmentation_tpu_torch.train import (
            Trainer,
            TrainingArguments,
        )

        args = TrainingArguments(**{
            "output_dir": os.path.join(self.workdir, name),
            "per_device_train_batch_size": self.batch,
            "per_device_eval_batch_size": self.batch,
            "learning_rate": self.learning_rate, "seed": self.seed,
            "logging_steps": 5, **kw})
        return Trainer(self.model(compute_dtype, device, remat, remat_policy),
                       args, self.train_ds, self.eval_ds, mesh=mesh,
                       device=device)


def _instrument_2d(trainer, rec, evals=None, stats_at=()):
    """Wrap the 2D trainer's step (synchronised ms, kernel-1 launches, the
    loss, the pre-clip grad norm of the update and, after the steps in
    ``stats_at``, the running statistics) and, given ``evals``, its eval
    forward (kernel-1 launches per eval batch)."""
    import torch

    from mdeical_image_segmentation_tpu_torch.ops import fused_conv

    step_fn, eval_fn = trainer._train_step, trainer._eval_forward

    def count():  # inside plain_path the plain version stands in: 0
        return getattr(fused_conv.fused_double2d, "launches", 0)

    def step(images, labels):
        torch.cuda.synchronize()
        before, t0 = count(), time.perf_counter()
        loss = step_fn(images, labels)
        torch.cuda.synchronize()
        rec.append({"ms": (time.perf_counter() - t0) * 1e3,
                    "loss": loss.item(),
                    "grad_norm": trainer.last_grad_norm.item(),
                    "launches": count() - before})
        if len(rec) in stats_at:
            rec[-1]["stats"] = _running_stats(trainer.model)
        return loss

    def eval_forward(batch):
        before = count()
        out = eval_fn(batch)
        evals.append(count() - before)
        return out

    trainer._train_step = step
    if evals is not None:
        trainer._eval_forward = eval_forward


DC2D_GROUPS = (("kernel 1 (conv core)", CONV_CORE), ("cuDNN", CUDNN))


def _profile_2d(trainer, steps: int = 3, groups=DC2D_GROUPS):
    """Device time of ``steps`` train steps on one device batch, grouped by
    the first of ``groups`` (name, kernel-name pattern) that matches, else
    "the rest" (phase 11: the port's conv core, cuDNN; phase 12: its own
    groups); wall and busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mdeical_image_segmentation_tpu_torch.data import SliceCollator

    batch = SliceCollator()([trainer.train_dataset[i]
                             for i in range(trainer.train_batch)])
    images = torch.from_numpy(batch["images"]).cuda()
    labels = torch.from_numpy(batch["labels"]).cuda()
    step = type(trainer)._train_step.__get__(trainer)  # not instrumented
    for _ in range(2):
        step(images, labels)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(images, labels)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    totals = {name: 0.0 for name, _ in groups}
    totals["the rest"] = 0.0
    times = device_times(prof)
    for k, ms in times.items():
        g = next((name for name, pat in groups if pat.search(k)), "the rest")
        totals[g] += ms / steps
    busy = sum(totals.values())
    top = sorted(times.items(), key=lambda kv: -kv[1])[:8]
    return totals, busy, wall, [(k[:70], v / steps) for k, v in top]


def phase_train_unet2d(seed: int, workdir: str):
    """The base-64 bf16 UNet at 256², batch 32, through Trainer.train():
    augmentation on, evaluation and checkpoints at steps 5 and 10; then the
    plain path; then 3 steps of each path from the same weights and
    batches, augmentation off, fp32 and bf16.  Returns the kernel-1
    launches of the main run and the numbers to print."""
    import numpy as np
    import torch

    from mdeical_image_segmentation_tpu_torch.models import UNetModel
    from mdeical_image_segmentation_tpu_torch.ops import fused_conv

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    setup = UNet2DTraining(seed, workdir)
    main_kw = dict(max_steps=TRAIN_STEPS_2D, eval_steps=5, save_steps=5,
                   save_total_limit=2, augment=True)
    trainer = setup.trainer("unet2d_train", **main_kw)
    log(f"[phase 11] UNet base 64, bf16 compute, fp32 master weights, 256², "
        f"batch {TRAIN_BATCH_2D}; {len(setup.train_ds)} train and "
        f"{len(setup.eval_ds)} eval slices; {trainer.args}")
    rec, evals = [], []
    _instrument_2d(trainer, rec, evals)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_conv.fused_double2d.launches = 0
    t0 = time.perf_counter()
    out = trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_conv.fused_double2d.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, r in enumerate(rec):
        log(f"  step {i + 1}: {r['ms']:.2f} ms, loss {r['loss']:.6f}, grad "
            f"norm {r['grad_norm']:.4e}, kernel-1 launches {r['launches']}")
    bad = [i + 1 for i, r in enumerate(rec)
           if r["launches"] != 18 or not np.isfinite(r["loss"])]
    # 2 evaluations x 2 passes (the mean threshold, then the sums) x 2
    # batches (32 and a tail of 8)
    if (bad or len(rec) != TRAIN_STEPS_2D or len(evals) != 8
            or any(n != 18 for n in evals)
            or launches != 18 * (len(rec) + len(evals))):
        raise AssertionError(
            f"steps {bad} off; {len(rec)} steps, eval batches {evals}, "
            f"{launches} launches: want {TRAIN_STEPS_2D} steps and 8 eval "
            "batches of 18 launches each, finite losses")
    ckpts = sorted(d for d in os.listdir(trainer.args.output_dir)
                   if d.startswith("checkpoint-"))
    if ckpts != ["checkpoint-10", "checkpoint-5"]:
        raise AssertionError(f"checkpoints {ckpts}")
    reloaded = UNetModel.from_pretrained(
        os.path.join(trainer.args.output_dir, "checkpoint-10"), device="cuda")
    for (k, a), (_, b) in zip(reloaded.state_dict().items(),
                              trainer.model.state_dict().items()):
        if not torch.equal(a, b):
            raise AssertionError(f"checkpoint-10 reloads {k} differently")
    metrics = trainer.evaluate()
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"eval metrics {metrics}")
    steady = statistics.median(r["ms"] for r in rec[2:])
    log(f"  train(): {len(rec)} steps + 2 evaluations in {wall:.2f} s; "
        f"training_loss {out.training_loss:.6f}; eval {metrics}; "
        f"checkpoints {ckpts} (checkpoint-10 reloads equal)")
    groups, busy, prof_wall, top = _profile_2d(trainer)
    del trainer, reloaded
    torch.cuda.empty_cache()

    # the plain path: the same run with kernel 1's plain version (cuDNN)
    with plain_path():
        plain = setup.trainer("unet2d_plain", max_steps=TRAIN_STEPS_2D,
                              eval_strategy="no", save_steps=0, augment=True)
        plain_rec = []
        _instrument_2d(plain, plain_rec)
        torch.cuda.reset_peak_memory_stats()
        plain.train()
        plain_peak = torch.cuda.max_memory_allocated() / 2**30
        p_groups, p_busy, p_wall, p_top = _profile_2d(plain)
    del plain
    torch.cuda.empty_cache()
    plain_steady = statistics.median(r["ms"] for r in plain_rec[2:])
    log(f"[phase 11] train step (median of steps 3-{TRAIN_STEPS_2D}, "
        f"synchronised): kernel path {steady:.2f} ms = "
        f"{TRAIN_BATCH_2D / steady * 1e3:.1f} slices/s, peak "
        f"{peak:.2f} GiB; plain path {plain_steady:.2f} ms = "
        f"{TRAIN_BATCH_2D / plain_steady * 1e3:.1f} slices/s, peak "
        f"{plain_peak:.2f} GiB")
    for label, g, b, w, t in (("kernel", groups, busy, prof_wall, top),
                              ("plain", p_groups, p_busy, p_wall, p_top)):
        log(f"[phase 11] profiled {label} step (3 steps, one batch): "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in g.items())
            + f"; device busy {b:.2f} of {w:.2f} ms wall ({100 * b / w:.1f}%)")
        log("    largest: " + "; ".join(f"{k} {v:.2f}" for k, v in t))

    # kernel path vs plain path from the same weights and batches, 3 steps,
    # augmentation off, fp32 (TF32 off) and bf16
    cmp_kw = dict(max_steps=3, eval_strategy="no", save_steps=0,
                  augment=False)
    gaps = {}
    for dtype, tols, norm_tol in (("float32", LOSS_TOLS, GRAD_NORM_TOL),
                                  ("bfloat16", BF16_LOSS_TOLS,
                                   BF16_GRAD_NORM_TOL)):
        runs = []
        for plain_run in (False, True):
            ctx = plain_path() if plain_run else contextlib.nullcontext()
            with ctx:
                t = setup.trainer(f"cmp_{dtype}_{int(plain_run)}", dtype,
                                  **cmp_kw)
                r = []
                _instrument_2d(t, r)
                t.train()
            runs.append(r)
            del t
            torch.cuda.empty_cache()
        k_rec, p_rec = runs
        rels = [abs(k["loss"] - p["loss"]) / abs(p["loss"])
                for k, p in zip(k_rec, p_rec)]
        norm_rel = (abs(k_rec[0]["grad_norm"] - p_rec[0]["grad_norm"])
                    / p_rec[0]["grad_norm"])
        for i, (k, p) in enumerate(zip(k_rec, p_rec)):
            log(f"  {dtype} step {i + 1}: loss kernel {k['loss']:.7f} plain "
                f"{p['loss']:.7f} (rel {rels[i]:.2e}, limit {tols[i]}); ms "
                f"kernel {k['ms']:.1f} plain {p['ms']:.1f}")
        log(f"  {dtype} grad norm after step 1: kernel "
            f"{k_rec[0]['grad_norm']:.7e} plain {p_rec[0]['grad_norm']:.7e} "
            f"(rel {norm_rel:.2e}, limit {norm_tol})")
        if any(r > t for r, t in zip(rels, tols)) or norm_rel > norm_tol:
            raise AssertionError(f"2D training, {dtype}, kernel path vs plain "
                                 f"path: losses {rels}, grad norm {norm_rel}"
                                 " beyond the limits")
        gaps[dtype] = (rels, norm_rel)
    return {"launches": launches, "steady": steady,
            "plain_steady": plain_steady, "peak": peak,
            "plain_peak": plain_peak, "gaps": gaps}


# ---------------------------------------------------------------------------
# 12. UNet-3+ training and serving (the 2D configuration of record)
# ---------------------------------------------------------------------------

U3P_RES = 512                # scripts/train.sh: 512², batch 5, lr 5e-3
U3P_BATCH = 5
U3P_STEPS = 10
# remat on vs remat off, the same weights and batches, augmentation off,
# 3 steps each with cuDNN's deterministic algorithms (the upsample's
# backward is a fixed-order matmul): relative loss gaps at steps 1, 2, 3,
# set before any run.  Remat recomputes the same operations on the same
# inputs, so step 1 should agree to the bit; steps 2-3 get phase 11's bf16
# kernel-vs-plain limits (AdamW turns a gradient that is rounding noise
# into a ±lr step).  Running statistics after step 1 (one update from the
# same forward: a second update in the recompute would show here) within
# 1e-6, after step 3 within 1e-3.  (Without deterministic algorithms the
# step-3 statistics moved 2e-2 between the two runs: atomics in the
# backward, amplified by two AdamW steps at 5e-3.)
U3P_REMAT_LOSS_TOLS = (1e-6, 1e-2, 5e-2)
U3P_STATS_TOLS = {1: 1e-6, 3: 1e-3}
# the card against the CPU: one fp32 step (TF32 off) at 176², batch 2,
# through the Trainer: loss and running statistics within 1e-5.  Its
# gradient norm sits below fp32's own resolution there: on the CPU,
# weights scaled by 1 ± 2^-23 move the fp32 norm by 0.6-1.9e-4 from the
# float64 one (BatchNorm over 242 values a channel at the bottleneck), so
# the step-1 gradient norm is held within 1e-4 in float64, the forward
# and backward of the same batch on both devices, and the fp32 norms are
# printed beside it.
U3P_CPU_RES, U3P_CPU_BATCH = 176, 2
U3P_CPU_LOSS_TOL = 1e-5
U3P_CPU_NORM_TOL = 1e-4
U3P_CPU_STATS_TOL = 1e-5
U3P_REQUESTS = 8             # per served bundle (UNet-3+ and CGM)


def _running_stats(model):
    import torch

    return torch.cat([b.detach().float().flatten().cpu()
                      for n, b in model.module.named_buffers()
                      if n.endswith(("running_mean", "running_var"))])


def _stats_rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


# phase 12's profile groups: the upsample's forward is ATen's
# interpolation kernel, its backward the only float32 GEMMs of the step
U3P_GROUPS = (
    ("upsample", re.compile(r"upsample|interp|sgemm|gemm_f32|magma", re.I)),
    ("cuDNN conv", re.compile(r"cudnn|xmma|dgrad|wgrad|fprop|implicit_gemm|"
                              r"conv2d|nchwToNhwc|nhwcToNchw", re.I)),
    ("batch norm", re.compile(r"batch_norm|welford", re.I)),
    ("copy/cast/cat", re.compile(r"copy|cast|CatArray|Memcpy|Memset", re.I)),
)


def _fp64_step(setup, device: str):
    """(loss, gradient norm) of one training-mode forward and backward of
    ``setup``'s model in float64 on its first batch, on ``device``."""
    import torch

    from mdeical_image_segmentation_tpu_torch.data import SliceCollator
    from mdeical_image_segmentation_tpu_torch.losses import segmentation_loss

    model = setup.model("float32", device)
    model.module.double().train()
    batch = SliceCollator()([setup.train_ds[i] for i in range(setup.batch)])
    images = torch.from_numpy(batch["images"]).to(device, torch.float64)
    labels = torch.from_numpy(batch["labels"]).to(device, torch.float64)
    loss = segmentation_loss(model.module(images), labels)
    loss.backward()
    norm = torch.linalg.vector_norm(torch.stack(
        [p.grad.norm() for p in model.parameters()]))
    return loss.item(), norm.item()


def _serve_u3p(registry, name: str, workdir: str, seed: int):
    """``U3P_REQUESTS`` 512² RGB PNGs, one after another, through
    ``SegmentationServer``; every mask must equal the threshold of the
    registered copy's own forward of the same image (batch 1 both)."""
    import numpy as np

    from mdeical_image_segmentation_tpu_torch.serve import SegmentationServer
    from mdeical_image_segmentation_tpu_torch.utils import png

    rng = np.random.default_rng(seed)
    srv = SegmentationServer(registry,
                             output_dir=os.path.join(workdir, "masks"),
                             max_batch=8, max_wait_ms=1.0)
    port = srv.start(host="127.0.0.1", port=0).server_address[1]
    entry = registry.get(name)
    lat, fg = [], []
    try:
        for i in range(U3P_REQUESTS):
            arr = rng.integers(0, 256, (U3P_RES, U3P_RES, 3), dtype=np.uint8)
            path = os.path.join(workdir, f"{name}_{i:02d}.png")
            png.write(path, arr)
            t0 = time.perf_counter()
            status, body = _post(port, {"image_path": path, "model": name,
                                        "return": "mask"})
            lat.append((time.perf_counter() - t0) * 1e3)
            if status != 200 or body.get("status") != 200:
                raise AssertionError(f"{name} request {i}: {status} {body}")
            mask = np.asarray(body["response"], np.uint8)
            probs = entry.probs_forward(
                arr[None].astype(np.float32) / 255.0)[0, ..., 0]
            want = (probs > 0.5).astype(np.uint8)
            if mask.shape != want.shape or not np.array_equal(mask, want):
                raise AssertionError(
                    f"{name} request {i}: the served mask differs from the "
                    f"thresholded forward at {int((mask != want).sum())} "
                    "pixels")
            fg.append(float(mask.mean()))
    finally:
        srv.stop()
    return statistics.median(lat), fg


def phase_train_unet3plus(seed: int, workdir: str):
    """UNet-3+ at the configuration of record through ``Trainer.train()``,
    remat off then on (``save_convs``); the card against the CPU at 176²;
    DeepSup and CGM 3 steps each; serving a UNet-3+ checkpoint and a CGM
    bundle.  Returns the numbers to print."""
    import numpy as np
    import torch

    from mdeical_image_segmentation_tpu_torch.models import UNetModel
    from mdeical_image_segmentation_tpu_torch.serve import ModelRegistry

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    setup = UNet2DTraining(seed, workdir, "UNet_3Plus", U3P_RES, 3,
                           n_train=20, n_eval=10, batch=U3P_BATCH,
                           learning_rate=5e-3)
    out = {}
    for remat in (False, True):
        label = "remat save_convs" if remat else "remat off"
        t = setup.trainer(f"u3p_remat{int(remat)}", remat=remat,
                          remat_policy="save_convs" if remat else None,
                          max_steps=U3P_STEPS, eval_steps=U3P_STEPS,
                          save_steps=U3P_STEPS, augment=False)
        if not remat:
            log(f"[phase 12] UNet_3Plus, 3 channels in, 1 out, bf16 compute, "
                f"fp32 master weights, {U3P_RES}², batch {U3P_BATCH}, hybrid "
                f"F1 + MS-SSIM + IoU; {len(setup.train_ds)} train and "
                f"{len(setup.eval_ds)} eval slices; "
                f"{sum(p.numel() for p in t.model.parameters())} parameters; "
                f"{t.args}")
        rec = []
        _instrument_2d(t, rec)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = t.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        for i, r in enumerate(rec):
            log(f"  {label} step {i + 1}: {r['ms']:.2f} ms, loss "
                f"{r['loss']:.6f}, grad norm {r['grad_norm']:.4e}")
        if (len(rec) != U3P_STEPS
                or not all(np.isfinite(r["loss"]) for r in rec)):
            raise AssertionError(f"UNet_3Plus {label}: {len(rec)} steps, "
                                 f"losses {[r['loss'] for r in rec]}")
        ckpt = os.path.join(t.args.output_dir, f"checkpoint-{U3P_STEPS}")
        reloaded = UNetModel.from_pretrained(ckpt, device="cuda")
        for (k, a), (_, b) in zip(reloaded.state_dict().items(),
                                  t.model.state_dict().items()):
            if not torch.equal(a, b):
                raise AssertionError(f"{ckpt} reloads {k} differently")
        steady = statistics.median(r["ms"] for r in rec[2:])
        log(f"[phase 12] UNet_3Plus {label}: step {steady:.2f} ms (median "
            f"of steps 3-{U3P_STEPS}, synchronised) = "
            f"{U3P_BATCH / steady * 1e3:.2f} images/s; peak "
            f"{peak:.2f} GiB over train() with its evaluation and "
            f"checkpoint; {len(rec)} steps in {wall:.2f} s; training_loss "
            f"{result.training_loss:.6f}; checkpoint-{U3P_STEPS} (params and "
            f"batch_stats) reloads equal")
        out[label] = {"step_ms": steady, "peak_gib": peak,
                      "images_per_s": U3P_BATCH / steady * 1e3}
        if not remat:
            out["ckpt"] = ckpt
            groups, busy, pwall, top = _profile_2d(t, 2, U3P_GROUPS)
            log(f"[phase 12] profiled remat-off step (2 steps, one batch): "
                + ", ".join(f"{k} {v:.2f} ms" for k, v in groups.items())
                + f"; device busy {busy:.2f} of {pwall:.2f} ms wall "
                f"({100 * busy / pwall:.1f}%)")
            log("    largest: " + "; ".join(f"{k} {v:.2f}" for k, v in top))
            out["profile"] = {"groups": groups, "busy": busy, "wall": pwall}
        del t, reloaded
        torch.cuda.empty_cache()
    # remat on vs off: 3 steps each, deterministic cuDNN
    torch.backends.cudnn.deterministic = True
    try:
        cmp = {}
        for remat in (False, True):
            t = setup.trainer(f"u3p_cmp{int(remat)}", remat=remat,
                              remat_policy="save_convs" if remat else None,
                              max_steps=3, eval_strategy="no", save_steps=0,
                              augment=False)
            cmp[remat] = []
            _instrument_2d(t, cmp[remat], stats_at=U3P_STATS_TOLS)
            t.train()
            del t
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    off, on = cmp[False], cmp[True]
    rels = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
            for a, b in zip(on, off)]
    stats_rel = {k: _stats_rel(on[k - 1]["stats"], off[k - 1]["stats"])
                 for k in U3P_STATS_TOLS}
    log(f"[phase 12] remat on vs off (deterministic cuDNN), steps 1-3: loss "
        f"gaps {', '.join(f'{r:.2e}' for r in rels)} (limits "
        f"{U3P_REMAT_LOSS_TOLS}); running statistics after steps 1 and 3 "
        f"within {stats_rel[1]:.2e} and {stats_rel[3]:.2e} relative (limits "
        f"{U3P_STATS_TOLS[1]}, {U3P_STATS_TOLS[3]})")
    if (len(rels) != 3
            or any(r > t for r, t in zip(rels, U3P_REMAT_LOSS_TOLS))
            or any(stats_rel[k] > t for k, t in U3P_STATS_TOLS.items())):
        raise AssertionError("UNet_3Plus remat on vs off beyond the limits")
    out["remat_gaps"] = rels + [stats_rel[1], stats_rel[3]]

    # the card against the CPU: one fp32 step at 176², the same weights and
    # batch (the CPU path is what the tests hold against the JAX package)
    small = UNet2DTraining(seed, workdir, "UNet_3Plus", U3P_CPU_RES, 3,
                           n_train=U3P_CPU_BATCH, n_eval=0,
                           batch=U3P_CPU_BATCH, learning_rate=5e-3)
    res = {}
    for device in ("cuda", "cpu"):
        t = small.trainer(f"u3p_{device}", "float32", device=device,
                          max_steps=1, eval_strategy="no", save_steps=0,
                          augment=False)
        rec = []
        _instrument_2d(t, rec)
        t0 = time.perf_counter()
        t.train()
        res[device] = (rec[0], _running_stats(t.model),
                       time.perf_counter() - t0)
        del t
    (g, g_stats, g_s), (c, c_stats, c_s) = res["cuda"], res["cpu"]
    loss_rel = abs(g["loss"] - c["loss"]) / abs(c["loss"])
    cpu_stats = _stats_rel(g_stats, c_stats)
    f64 = {d: _fp64_step(small, d) for d in ("cuda", "cpu")}
    norm_rel = abs(f64["cuda"][1] - f64["cpu"][1]) / f64["cpu"][1]
    log(f"[phase 12] card vs CPU, UNet_3Plus fp32 (TF32 off) at "
        f"{U3P_CPU_RES}², batch {U3P_CPU_BATCH}, one Trainer step: loss "
        f"{g['loss']:.7f} / {c['loss']:.7f} (rel {loss_rel:.2e}, limit "
        f"{U3P_CPU_LOSS_TOL}); running statistics {cpu_stats:.2e} (limit "
        f"{U3P_CPU_STATS_TOL}); fp32 grad norm {g['grad_norm']:.7e} / "
        f"{c['grad_norm']:.7e} ({g_s:.1f} s card, {c_s:.1f} s CPU); "
        f"float64 step: loss {f64['cuda'][0]:.12f} / {f64['cpu'][0]:.12f}, "
        f"grad norm {f64['cuda'][1]:.10e} / {f64['cpu'][1]:.10e} (rel "
        f"{norm_rel:.2e}, limit {U3P_CPU_NORM_TOL}); the fp32 norms off the "
        f"float64 one by {abs(g['grad_norm'] / f64['cpu'][1] - 1):.2e} "
        f"(card), {abs(c['grad_norm'] / f64['cpu'][1] - 1):.2e} (CPU)")
    if (loss_rel > U3P_CPU_LOSS_TOL or norm_rel > U3P_CPU_NORM_TOL
            or cpu_stats > U3P_CPU_STATS_TOL):
        raise AssertionError("UNet_3Plus: the card's step differs from the "
                             "CPU's beyond the limits")
    out["cpu_gaps"] = (loss_rel, norm_rel, cpu_stats)

    # the other two types: 3 steps each at 512², batch 5; CGM twice
    other = {}
    for unet_type, runs in (("UNet_3Plus_DeepSup", 1),
                            ("UNet_3Plus_DeepSup_CGM", 2)):
        s = UNet2DTraining(seed, workdir, unet_type, U3P_RES, 3, n_train=15,
                           n_eval=0, batch=U3P_BATCH, learning_rate=5e-3)
        losses = []
        for run in range(runs):
            t = s.trainer(f"{unet_type}_{run}", max_steps=3,
                          eval_strategy="no", save_steps=0, augment=False)
            rec = []
            _instrument_2d(t, rec)
            t.train()
            losses.append([r["loss"] for r in rec])
            if not all(np.isfinite(v) for v in losses[-1]):
                raise AssertionError(f"{unet_type}: losses {losses[-1]}")
            log(f"  {unet_type} run {run + 1}: losses "
                + ", ".join(f"{v:.6f}" for v in losses[-1])
                + "; steps " + ", ".join(f"{r['ms']:.1f}" for r in rec)
                + " ms")
            if unet_type.endswith("CGM") and run == 0:
                out["cgm_bundle"] = os.path.join(workdir, "cgm_bundle")
                t.save_model(out["cgm_bundle"])
            del t
            torch.cuda.empty_cache()
        if runs == 2:
            gaps = [abs(a - b) / abs(b) for a, b in zip(*losses)]
            log(f"[phase 12] CGM from one seed twice (its dropout from the "
                f"trainer's generator): loss gaps "
                f"{', '.join(f'{v:.2e}' for v in gaps)} (limits "
                f"{U3P_REMAT_LOSS_TOLS})")
            if any(v > t for v, t in zip(gaps, U3P_REMAT_LOSS_TOLS)):
                raise AssertionError("CGM: the same seed gave other losses")
        other[unet_type] = losses[0]
    out["other"] = other

    # serving: the UNet_3Plus checkpoint and the CGM bundle at 512²
    registry = ModelRegistry()
    t0 = time.time()
    registry.register_unet2d("unet3plus", out["ckpt"], resolution=U3P_RES,
                             device="cuda")
    registry.register_unet2d("cgm", out["cgm_bundle"], resolution=U3P_RES,
                             device="cuda")
    log(f"[phase 12] registered UNet_3Plus checkpoint-{U3P_STEPS} and the "
        f"CGM bundle (load + warm-up of batches 1..8 each) in "
        f"{time.time() - t0:.2f} s")
    for name in ("unet3plus", "cgm"):
        p50, fg = _serve_u3p(registry, name, workdir, seed)
        log(f"[phase 12] served {name}: {U3P_REQUESTS} requests at "
            f"{U3P_RES}², one at a time, every mask equal to the thresholded "
            f"forward of the registered copy; median latency {p50:.1f} ms; "
            f"foreground shares {', '.join(f'{v:.3f}' for v in fg)}")
        out[f"serve_{name}_p50_ms"] = p50
    return out


# ---------------------------------------------------------------------------
# the config-driven 3D pipeline: cli/train3d.py and cli/predict3d.py on
# configs/unet3d_train.yml and configs/unet3d_predict.yml, HDF5 volumes
# ---------------------------------------------------------------------------

H5_TRAIN_VOLUME = (80, 350, 350)  # 1 x 3 x 3 train patches at 40x90x90
H5_VAL_VOLUME = (80, 170, 340)    # 2 val patches at stride = patch
H5_LABEL_QUANTILE = 25  # label: the smoothed raw above this percentile
# trainer.max_num_iterations: 11 steps, over the epoch's 9 patches and into
# the next; the train pipelines' seeded ElasticDeformation fires first at
# sample 10, so one step waits for it
H5_STEPS = 10


def write_h5_volume(path, raw, label=None):
    """A volume (and its label) as users' files usually are: chunked and
    gzip-compressed (h5py's chunk guess, level 4), with the port's codec."""
    from mdeical_image_segmentation_tpu_torch.utils import hdf5

    with hdf5.File(path, "w") as f:
        f.create_dataset("raw", data=raw, compression="gzip")
        if label is not None:
            f.create_dataset("label", data=label, compression="gzip")
    return os.path.getsize(path)


def foreground_label(raw):
    """The smoothed raw above its 25th percentile, uint8: patches well above
    FilterSliceBuilder's 0.6 foreground threshold."""
    import numpy as np

    v = _smoothed(raw)
    return (v > np.percentile(v, H5_LABEL_QUANTILE)).astype(np.uint8)


class _io_timer:
    """Within this block, every HDF5 dataset read and dataset write of the
    port's codec is timed (host clock) and its bytes counted: a dataset made
    from data, and each region written into a chunked one."""

    def __enter__(self):
        from mdeical_image_segmentation_tpu_torch.utils import hdf5

        self.reads = self.read_bytes = self.read_s = 0.0
        self.write_bytes = self.write_s = 0.0
        self.saved = (hdf5.Dataset.__getitem__, hdf5.File.create_dataset,
                      hdf5.Dataset.__setitem__)
        get, create, put = self.saved
        timer = self
        inside = threading.local()  # a create's own region write is its

        def timed_get(ds, index):
            t0 = time.perf_counter()
            out = get(ds, index)
            timer.read_s += time.perf_counter() - t0
            timer.reads += 1
            timer.read_bytes += out.nbytes
            return out

        def timed_create(f, name, data=None, **kw):
            t0 = time.perf_counter()
            inside.on = True
            try:
                out = create(f, name, data, **kw)
            finally:
                inside.on = False
            timer.write_s += time.perf_counter() - t0
            timer.write_bytes += 0 if data is None else data.nbytes
            return out

        def timed_put(ds, index, value):
            if getattr(inside, "on", False):
                return put(ds, index, value)
            t0 = time.perf_counter()
            put(ds, index, value)
            timer.write_s += time.perf_counter() - t0
            timer.write_bytes += getattr(value, "nbytes", 0)

        hdf5.Dataset.__getitem__ = timed_get
        hdf5.File.create_dataset = timed_create
        hdf5.Dataset.__setitem__ = timed_put
        return self

    def __exit__(self, *exc):
        from mdeical_image_segmentation_tpu_torch.utils import hdf5

        (hdf5.Dataset.__getitem__, hdf5.File.create_dataset,
         hdf5.Dataset.__setitem__) = self.saved


class _TimedLoader:
    """The trainer's train loader with the host time the trainer waits in
    each ``next()`` noted (ms)."""

    def __init__(self, loader, waits):
        self.loader, self.waits = loader, waits
        # a device-cached loader's batches are taken as they come
        self.is_device_cached = getattr(loader, "is_device_cached", False)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                self.waits.append((time.perf_counter() - t0) * 1e3)
                yield batch
        finally:
            it.close()


def _transform_times(cfg, raw_patch, label_patch):
    """Host ms of each transform of the train pipelines on one patch, on
    this machine's CPU; a transform that fires with a probability is timed
    firing, and its expected cost is that times the probability."""
    import numpy as np

    from mdeical_image_segmentation_tpu_torch.transforms.volume import (
        TRANSFORMS,
    )

    rows = []
    for name, m in (("raw", raw_patch), ("label", label_patch)):
        for c in cfg["loaders"]["train"]["transformer"][name]:
            t = TRANSFORMS.get(c["name"])(
                random_state=np.random.RandomState(SEED), **c)
            p = getattr(t, "execution_probability", 1.0)
            if p < 1.0:
                t.execution_probability = 1.0
            t0 = time.perf_counter()
            m = t(m)
            ms = (time.perf_counter() - t0) * 1e3
            rows.append((name, c["name"], ms, p))
    return rows


def phase_config_train(seed: int, workdir: str, in_memory_step_ms: float):
    """cli/train3d.py on configs/unet3d_train.yml, its overrides only the
    file paths, the checkpoint directory and the step counts: the model,
    patch, stride and whole transformer pipeline as the yml has them."""
    import numpy as np
    import torch

    from mdeical_image_segmentation_tpu_torch.cli import train3d
    from mdeical_image_segmentation_tpu_torch.train import trainer3d
    from mdeical_image_segmentation_tpu_torch.utils import hdf5

    raw = seeded_volume(H5_TRAIN_VOLUME, seed + 4)
    val_raw = seeded_volume(H5_VAL_VOLUME, seed + 5)
    label, val_label = foreground_label(raw), foreground_label(val_raw)
    t0 = time.perf_counter()
    train_h5 = os.path.join(workdir, "train_volume.h5")
    val_h5 = os.path.join(workdir, "val_volume.h5")
    sizes = (write_h5_volume(train_h5, raw, label),
             write_h5_volume(val_h5, val_raw, val_label))
    write_s = time.perf_counter() - t0
    cfg = read_yaml_subset(TRAIN_YML)
    sb = cfg["loaders"]["train"]["slice_builder"]
    windows = [tuple(slice(o, o + p) for o, p in zip(origin, sb["patch_shape"]))
               for origin in _windows(H5_TRAIN_VOLUME, sb["patch_shape"],
                                      sb["stride_shape"])]
    shares = [float(label[w].mean()) for w in windows]
    log(f"[phase 13] wrote {train_h5} ({H5_TRAIN_VOLUME}, raw float32 + "
        f"label uint8, {sizes[0] / 2**20:.1f} MiB) and the val volume "
        f"({H5_VAL_VOLUME}, {sizes[1] / 2**20:.1f} MiB), chunked + gzip, in "
        f"{write_s:.2f} s; label: smoothed raw above its "
        f"{H5_LABEL_QUANTILE}th percentile, foreground share of the "
        f"{len(shares)} train windows {min(shares):.3f}-{max(shares):.3f} "
        f"(threshold {sb['threshold']})")
    run_dir = os.path.join(workdir, "config_train")
    argv = ["--config", TRAIN_YML,
            "--loaders.train.file_paths", repr([train_h5]),
            "--loaders.val.file_paths", repr([val_h5]),
            "--trainer.checkpoint_dir", run_dir,
            "--trainer.max_num_iterations", str(H5_STEPS),
            "--trainer.validate_after_iters", "3",
            "--trainer.log_after_iters", "3"]
    log(f"  train3d argv: {' '.join(argv)}")
    rec, waits = [], []
    made = []
    create = trainer3d.create_trainer

    def instrumented(config):
        t = create(config)
        _instrument(t, rec)
        t.loaders["train"] = _TimedLoader(t.loaders["train"], waits)
        made.append(t)
        return t

    trainer3d.create_trainer = instrumented
    threads = set(threading.enumerate())
    try:
        with _io_timer() as io:
            torch.cuda.synchronize()
            _zero_counts()
            t0 = time.perf_counter()
            trainer = train3d.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _counts()
    finally:
        trainer3d.create_trainer = create
    # a loader's prefetch thread (VolumeLoader's "producer") sees that the
    # trainer stopped only after the sample it is assembling: wait for it,
    # so that the next phase runs on an idle host, and release the loaders'
    # worker threads
    t0 = time.perf_counter()
    for t in set(threading.enumerate()) - threads:
        if t.name.endswith("(producer)"):
            t.join(timeout=120)
    drain = time.perf_counter() - t0
    trainer.loaders["train"].loader.close()
    trainer.loaders["val"].close()
    if trainer is not made[0]:
        raise AssertionError("train3d did not return the trainer it built")
    if next(trainer.model.parameters()).device.type != DEVICE:
        raise AssertionError(f"train3d's model is not on {DEVICE}")
    n_train = len(trainer.loaders["train"])
    convs = 2 * (2 * cfg["model"]["num_levels"] - 1)
    want = {"gcr_conv3d": convs, "gn_stats": convs, "gn_affine": convs,
            "gn_bwd_reduce": convs, "gn_bwd_dx": convs - 1, "overlap_add": 0}
    for i, r in enumerate(rec):
        log(f"  step {i + 1}: {r['ms']:.1f} ms, loss {r['loss']:.6f}, "
            f"launches {r['launches']}")
        if r["launches"] != want or not np.isfinite(r["loss"]):
            raise AssertionError(f"step {i + 1}: {r}, want launches {want} "
                                 "and a finite loss")
    log("  loader waits per batch pulled (ms; the trainer pulls batch k + 1 "
        "before it runs step k): " + ", ".join(f"{w:.1f}" for w in waits))
    if len(rec) != H5_STEPS + 1:
        raise AssertionError(f"{len(rec)} steps, want {H5_STEPS + 1}")
    for name in ("last_checkpoint.msgpack", "best_checkpoint.msgpack",
                 os.path.join("logs", "config.yml")):
        if not os.path.exists(os.path.join(run_dir, name)):
            raise AssertionError(f"train3d wrote no {name}")
    copied = read_yaml_subset(os.path.join(run_dir, "logs", "config.yml"))
    if (copied["trainer"]["max_num_iterations"] != H5_STEPS
            or copied["loaders"]["train"]["transformer"]
            != cfg["loaders"]["train"]["transformer"]):
        raise AssertionError("the copied config is not the resolved one")
    step = statistics.median(r["ms"] for r in rec[1:])
    wait = statistics.median(waits[1:])
    log(f"[phase 13] train3d: {len(rec)} steps + 3 validations in "
        f"{wall:.2f} s ({n_train} train patches kept by FilterSliceBuilder "
        f"of {len(windows)}); device step median {step:.1f} ms (phase 9's "
        f"in-memory step {in_memory_step_ms:.1f} ms); loader wait median "
        f"{wait:.1f} ms, max {max(waits):.1f} ms, total "
        f"{sum(waits) / 1e3:.2f} s of the {wall:.2f} s; host share of the "
        f"steps' wall (wait / (wait + step)) "
        f"{sum(waits) / (sum(waits) + sum(r['ms'] for r in rec)):.3f}; the "
        f"prefetch thread finished its last sample {drain:.2f} s after fit "
        "returned")
    log(f"[phase 13] HDF5 reads: {io.reads:.0f} dataset reads, "
        f"{io.read_bytes / 2**20:.1f} MiB out, {io.read_s:.2f} s")
    with hdf5.File(train_h5) as f:
        w = windows[0]
        raw_patch, label_patch = f["raw"][w], f["label"][w]
    rows = _transform_times(cfg, raw_patch, label_patch)
    expected = {}
    for pipe, name, ms, p in rows:
        expected[pipe] = expected.get(pipe, 0.0) + ms * p
    log(f"[phase 13] transforms, host ms per sample on this machine's CPU "
        f"(one {'x'.join(map(str, raw_patch.shape))} patch; a transform "
        "with a probability timed firing): " + "; ".join(
            f"{pipe} {name} {ms:.1f}" + (f" (p {p}: {ms * p:.1f} expected)"
                                         if p < 1 else "")
            for pipe, name, ms, p in rows)
        + f"; expected per sample: raw {expected['raw']:.1f}, label "
        f"{expected['label']:.1f}")
    best = os.path.join(run_dir, "best_checkpoint.msgpack")
    del trainer, made
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step, "wait_ms": wait,
            "waits_s": sum(waits) / 1e3, "wall_s": wall, "best": best,
            "expected_ms": expected, "read_s": io.read_s,
            "read_mib": io.read_bytes / 2**20, "train_h5": train_h5,
            "val_h5": val_h5}


def standardized_patch_batches(raw, slices, batch_size):
    """In memory, the batches the HDF5 test dataset and loader give for the
    predict yml's pipeline (Standardize per halo-padded window, then
    ToTensor(expand_dims)): the windows are views of the mirror-padded
    volume, as the dataset's are."""
    import numpy as np

    from mdeical_image_segmentation_tpu_torch.data.slice_builder import (
        get_slice_builder,
    )
    from mdeical_image_segmentation_tpu_torch.data.volume_utils import (
        create_padded_indexes,
        mirror_pad,
    )
    from mdeical_image_segmentation_tpu_torch.transforms.volume import (
        Standardize,
        ToTensor,
    )

    halo = slices["halo_shape"]
    padded = mirror_pad(raw, halo)
    windows = get_slice_builder(raw, None, None, slices).raw_slices
    to_tensor = ToTensor(expand_dims=True)
    for b0 in range(0, len(windows), batch_size):
        idx = windows[b0:b0 + batch_size]
        yield np.stack([to_tensor(Standardize()(
            padded[create_padded_indexes(w, halo)])) for w in idx]), idx


def phase_config_predict(seed: int, workdir: str, checkpoint: str):
    """cli/predict3d.py on configs/unet3d_predict.yml, its overrides only
    model_path, output_dir and the file path; the file it writes against
    the in-memory predictor and the plain path."""
    import numpy as np
    import torch

    from mdeical_image_segmentation_tpu_torch.cli import predict3d
    from mdeical_image_segmentation_tpu_torch.infer import (
        predictor as predictor_lib,
    )
    from mdeical_image_segmentation_tpu_torch.utils import hdf5

    raw = seeded_volume(VOLUME_3D, seed)
    path = os.path.join(workdir, "predict_volume.h5")
    write_h5_volume(path, raw)
    out_dir = os.path.join(workdir, "predictions")
    argv = ["--config", PREDICT_YML, "--model_path", checkpoint,
            "--output_dir", out_dir,
            "--loaders.test.file_paths", repr([path])]
    log(f"[phase 14] predict3d argv: {' '.join(argv)}")
    rec, made = [], []
    get = predictor_lib.get_predictor

    def instrumented(model, output_dir, config, **kw):
        p = get(model, output_dir, config, **kw)
        _timed_batches(p, rec)
        made.append(p)
        return p

    predictor_lib.get_predictor = instrumented
    try:
        with _io_timer() as io:
            torch.cuda.synchronize()
            _zero_counts()
            t0 = time.perf_counter()
            outputs = predict3d.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _counts()
    finally:
        predictor_lib.get_predictor = get
    for i, (ms, n) in enumerate(rec):
        log(f"  batch {i}: {ms:.1f} ms, launches {n}")
        if n["gcr_conv3d"] != 14 or n["gn_stats"] != 14:
            raise AssertionError(f"batch {i}: {n}, want 14 gcr_conv3d and "
                                 "14 gn_stats launches")
    if len(rec) != 2 or launches["overlap_add"] != len(rec):
        raise AssertionError(f"{launches} over {len(rec)} batches: want 2 "
                             "batches, one overlap_add each")
    want_file = os.path.join(out_dir, "predict_volume_predictions.h5")
    if [str(o) for o in outputs] != [want_file]:
        raise AssertionError(f"predict3d wrote {outputs}, want {want_file}")
    with hdf5.File(want_file) as f:
        got = f["predictions"][:]
        compression = f["predictions"].compression
    log(f"[phase 14] predict3d: {wall:.2f} s in all; HDF5 write "
        f"{io.write_s:.2f} s ({io.write_bytes / 2**20:.1f} MiB, "
        f"{compression}), reads {io.read_s:.2f} s "
        f"({io.read_bytes / 2**20:.1f} MiB); {want_file} holds "
        f"'predictions' {got.shape} {got.dtype}")

    cfg = read_yaml_subset(PREDICT_YML)
    slices, batch_size = (cfg["loaders"]["test"]["slice_builder"],
                          cfg["loaders"]["batch_size"])
    model = made[0].model
    config = {"model": cfg["model"], "predictor": cfg["predictor"]}
    pred = get(model, None, config)
    acc, cnt = pred._device_accumulate(
        standardized_patch_batches(raw, slices, batch_size), raw.shape,
        slices["halo_shape"])
    want = acc / cnt
    if got.shape != want.shape or got.dtype != want.dtype or not (
            np.array_equal(got, want)):
        diff = (float(np.abs(got - want).max()) if got.shape == want.shape
                else None)
        raise AssertionError(f"the prediction file differs from the "
                             f"in-memory map: {got.shape} {got.dtype} vs "
                             f"{want.shape} {want.dtype}, max |diff| {diff}")
    log("  the file equals the in-memory _device_accumulate map, divided as "
        "_save_results divides, bit for bit")
    with plain_path():
        plain = get(model, None, config)
        plain_maps = plain._device_accumulate(
            standardized_patch_batches(raw, slices, batch_size), raw.shape,
            slices["halo_shape"])
    err = _check_maps("config-driven UNet3D predictor", (acc, cnt),
                      plain_maps, UNET3D_MAP_TOL)
    del pred, plain, made, model
    torch.cuda.empty_cache()
    return {"launches": launches, "wall_s": wall, "write_s": io.write_s,
            "err": err, "volume": path, "file": want_file}


# ---------------------------------------------------------------------------
# The rest of the 3D family: bf16 compute, device_cache, ResidualUNetSE3D,
# BatchNorm, the 2D members and remat
# ---------------------------------------------------------------------------

# bench.py:134-183 (bench_unet3d): 'gcr', bf16, batch 2 at 64x128x128, x =
# RandomState(0).rand, y = x > 0.5, BCEDice, Adam 1e-3; its rows
# unet3d_fmaps32_64x128x128 and residual_unet3d_fmaps32_64x128x128
# (bench.py:693, :701)
BENCH_3D_ROWS = (
    ("unet3d_fmaps32_64x128x128",
     {"name": "UNet3D", "in_channels": 1, "out_channels": 1, "f_maps": 32,
      "num_levels": 4, "layer_order": "gcr", "dtype": "bfloat16"}, 5, 3),
    ("residual_unet3d_fmaps32_64x128x128",
     {"name": "ResidualUNet3D", "in_channels": 1, "out_channels": 1,
      "f_maps": 32, "num_levels": 5, "layer_order": "gcr",
      "dtype": "bfloat16"}, 2, 2),
)
BENCH_3D_BATCH = 2
BENCH_3D_PATCH = (64, 128, 128)
BENCH_3D_CFG = {"loss": {"name": "BCEDiceLoss"},
                "eval_metric": {"name": "MeanIoU"},
                "optimizer": {"name": "Adam", "learning_rate": 1e-3},
                "lr_scheduler": None, "trainer": {}}
BF16_STEPS = 5           # phase 15 (a): step ms is the median of steps 3-5
# the bf16 predictor batch's averaged map, x max(1, |map|): against the
# plain bf16 path (both round every layer's output to bf16; the CPU tests
# hold bf16 logits to 3e-2 of max |y|) and against the fp32 map (bf16's 8
# bits, about 4e-3 relative, compounded through 14 layers)
BF16_MAP_TOL = 3e-2
BF16_FP32_MAP_TOL = 1e-1
BF16_PREDICT_VOLUME = (80, 340, 340)  # 1 x 2 x 2 patches: one batch of 4
# bench.py:228-300 (bench_device_cache_e2e): a RandomState(0).rand
# 128x256x256 train volume, label > 0.6, val its first 64 slices;
# Standardize + RandomFlip; UNet3D f_maps 32, 'gcr', fp32, batch 2, patch =
# stride = 64x128x128 (8 patches, 4 steps an epoch)
DC_VOLUME = (128, 256, 256)
DC_TIMED_EPOCHS = 3
# phase 17's runs: (name, model, volume, patch, batch); bench's patch
FAMILY_ROWS = (
    ("ResidualUNetSE3D", {"name": "ResidualUNetSE3D", "in_channels": 1,
                          "out_channels": 1, "f_maps": 32, "num_levels": 5,
                          "layer_order": "gcr"},
     (64, 128, 256), (64, 128, 128), 2),
    ("UNet3D 'bcr'", {"name": "UNet3D", "in_channels": 1, "out_channels": 1,
                      "f_maps": 32, "num_levels": 4, "layer_order": "bcr"},
     (64, 128, 256), (64, 128, 128), 2),
    ("UNet2D", {"name": "UNet2D", "in_channels": 1, "out_channels": 1,
                "f_maps": 64, "num_levels": 4, "layer_order": "gcr"},
     (8, 256, 256), (1, 256, 256), 8),
    ("ResidualUNet2D", {"name": "ResidualUNet2D", "in_channels": 1,
                        "out_channels": 1, "f_maps": 64, "num_levels": 5,
                        "layer_order": "gcr"},
     (8, 256, 256), (1, 256, 256), 8),
)
FAMILY_STEPS = 3
BCR_CPU_PATCH = (32, 64, 64)
CPU_TOL = 1e-5           # 'bcr' step, card vs CPU: loss and running stats
REMAT_STEPS = 3


def _per_step(convs_fused, gn_module, gcr_dx=True):
    """Launches a training step makes: ``convs_fused`` fused 'gcr'
    SingleConvs (kernel 2 and 3a forward; 3b's recompute, 3c and 3d
    backward), ``gn_module`` GroupNorm modules (3a and 3b forward; 3c and 3d
    backward); with ``gcr_dx`` the model's first GroupNorm reads the image,
    which needs no dx."""
    n_dx = convs_fused + gn_module - (1 if gcr_dx else 0)
    return {"gcr_conv3d": convs_fused,
            "gn_stats": convs_fused + gn_module,
            "gn_affine": convs_fused + gn_module,
            "gn_bwd_reduce": convs_fused + gn_module,
            "gn_bwd_dx": n_dx, "overlap_add": 0}


def _paired_runs(label, model_cfg, cfg, make_loaders, ckpt, workdir, steps,
                 plain_steps, want=None):
    """``steps`` steps of UNetTrainer on the kernel path, then
    ``plain_steps`` on the plain path from the same weights and batches:
    (records, plain records, launches by dtype, peak GiB, plain peak)."""
    import numpy as np
    import torch

    kw = dict(max_num_iterations=steps - 1, validate_after_iters=10**9,
              log_after_iters=10**9)
    trainer = _make_trainer(model_cfg, cfg, make_loaders(),
                            os.path.join(workdir, label), ckpt, **kw)
    rec = []
    _instrument(trainer, rec)
    torch.cuda.synchronize()
    # earlier phases' trainers may still await collection: the peak is
    # read over this run's own tensors and whatever else stays alive
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    trainer.fit()
    by_dtype = _dtype_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, r in enumerate(rec):
        log(f"  step {i + 1}: {r['ms']:.1f} ms, loss {r['loss']:.6f}, "
            f"launches {r['launches']}")
        if (want is not None and r["launches"] != want) or not np.isfinite(
                r["loss"]):
            raise AssertionError(f"{label} step {i + 1}: {r['launches']}, "
                                 f"want {want} and a finite loss")
    if len(rec) != steps:
        raise AssertionError(f"{label}: {len(rec)} steps, want {steps}")
    # _instrument's wrapper holds the trainer in a cycle: collect it now,
    # or its weights and Adam state stay in the next run's peak
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    with plain_path():
        plain = _make_trainer(model_cfg, cfg, make_loaders(),
                              os.path.join(workdir, label + "_plain"), ckpt,
                              **{**kw, "max_num_iterations": plain_steps - 1})
        plain_rec = []
        _instrument(plain, plain_rec)
        torch.cuda.reset_peak_memory_stats()
        plain.fit()
        plain_peak = torch.cuda.max_memory_allocated() / 2**30
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    return rec, plain_rec, by_dtype, peak, plain_peak


def _steady(rec, skip=2):
    return statistics.median(r["ms"] for r in rec[skip:] or rec[-1:])


def _bf16_gcr_shapes(model_cfg, patch, batch):
    """The input shapes (and Co) of every bf16 fused 'gcr' SingleConv of
    ``model_cfg`` at ``patch``: one no-grad forward with hooks."""
    import torch

    from mdeical_image_segmentation_tpu_torch.models import (
        SingleConv,
        get_model,
    )

    model = get_model(model_cfg, device=DEVICE).eval()
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.02)
    found = []

    def hook(mod, args):
        if mod.fused and args[0].dtype == torch.bfloat16:
            found.append((tuple(args[0].shape),
                          mod.TorchConv_0.weight.shape[0]))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, SingleConv)]
    with torch.no_grad():
        model(torch.zeros((batch, *patch, model_cfg["in_channels"]),
                          device=DEVICE))
    for h in handles:
        h.remove()
    del model
    torch.cuda.empty_cache()
    return found


def phase_bf16_forward_convs(seed: int, shapes):
    """Kernel 2 in bf16 at the bf16 training step's fused shapes against
    its plain version (affine rounded to bf16, cuDNN conv3d in bf16) within
    2e-2, timed in turns with the plain version and cuDNN's conv3d alone;
    the bound at the bf16 peak."""
    import torch
    import torch.nn.functional as F

    from mdeical_image_segmentation_tpu_torch.ops import fused_conv

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    rec = {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "bound_ms": 0.0, "op_ms": 0.0, "byte_ms": 0.0, "device_ms": 0.0}
    flop_sum = 0.0
    for shape, co in shapes:
        ci = shape[-1]
        x = _rand(gen, shape, torch.bfloat16)
        k = _rand(gen, (3, 3, 3, ci, co), torch.bfloat16, (27 * ci) ** -0.5)
        a = torch.rand((shape[0], ci), device=DEVICE, generator=gen) + 0.5
        b = 0.5 * torch.randn((shape[0], ci), device=DEVICE, generator=gen)
        err = _compare(f"gcr_conv3d bf16 {shape}->{co}",
                       fused_conv.fused_conv3d(x, k, a, b),
                       fused_conv.fused_conv3d_reference(x, k, a, b),
                       BF16_TOL)
        xc, kc = x.permute(0, 4, 1, 2, 3), k.permute(4, 3, 0, 1, 2)
        k_ms, p_ms, l_ms = _time_turns(
            lambda: fused_conv.fused_conv3d(x, k, a, b),
            lambda: fused_conv.fused_conv3d_reference(x, k, a, b),
            lambda: F.conv3d(xc, kc, padding=1))
        # the conv core (conv_halo_kernel / conv_gather_kernel) is the one
        # kernel a call launches
        d_ms = _device_ms(lambda: fused_conv.fused_conv3d(x, k, a, b),
                          tries=8, name="conv_")
        flop, nbytes = _gcr_flop_bytes(shape, co, 3, 2)
        rec["err"] = max(rec["err"], err)
        rec["ms"] += k_ms
        rec["device_ms"] += d_ms
        rec["plain_ms"] += p_ms
        rec["library_ms"] += l_ms
        rec["bound_ms"] += _bound_ms(flop, nbytes, PEAK_BF16)[0]
        rec["op_ms"] += flop / PEAK_BF16 * 1e3
        rec["byte_ms"] += nbytes / HBM_BYTES_PER_S * 1e3
        flop_sum += flop
        log(f"  bf16 fwd {str(shape):26s} -> {co:4d}: err {err:.2e}; kernel "
            f"{k_ms:8.3f} ms {_rate(flop, k_ms, torch.bfloat16)}, device "
            f"{d_ms:8.3f} ms; plain {p_ms:8.3f} ms; cuDNN {l_ms:8.3f} ms")
        del x, k, xc, kc
        torch.cuda.empty_cache()
    log(f"[phase 15] kernel 2 in bf16 at the {len(shapes)} fused shapes of "
        f"the bf16 training step: kernel {rec['ms']:.3f} ms (device "
        f"{_ms(rec['device_ms'])}), plain "
        f"{rec['plain_ms']:.3f} ms, cuDNN conv3d {rec['library_ms']:.3f} ms; "
        f"bound {rec['bound_ms']:.3f} ms (share "
        f"{_share(rec['bound_ms'], rec['ms'])}); kernel "
        f"{_rate(flop_sum, rec['ms'], torch.bfloat16)}")
    return rec


def _bf16_predictor_batch(seed: int):
    """One batch of 4 patches of phase 3's configuration (its weights, from
    the same seed) through ``StandardPredictor`` with the model in bf16:
    its averaged map against the fp32 model's and against the plain bf16
    path."""
    import numpy as np
    import torch

    from mdeical_image_segmentation_tpu_torch.data.volume_utils import (
        padded_patch_batches,
    )
    from mdeical_image_segmentation_tpu_torch.infer import get_predictor
    from mdeical_image_segmentation_tpu_torch.models import get_model

    cfg = read_yaml_subset(PREDICT_YML)
    slices, batch_size = (cfg["loaders"]["test"]["slice_builder"],
                          cfg["loaders"]["batch_size"])
    state = get_model(cfg["model"], generator=torch.Generator().manual_seed(
        seed)).state_dict()
    raw = seeded_volume(BF16_PREDICT_VOLUME, seed + 6)

    def run(dtype):
        model_cfg = {**cfg["model"], "dtype": dtype}
        model = get_model(model_cfg, device=DEVICE)
        model.load_state_dict(state)
        model.eval()
        pred = get_predictor(model, None, {"model": model_cfg,
                                           "predictor": cfg["predictor"]})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc, cnt = pred._device_accumulate(
            padded_patch_batches(raw, slices, batch_size), raw.shape,
            slices["halo_shape"])
        ms = (time.perf_counter() - t0) * 1e3
        del model, pred
        torch.cuda.empty_cache()
        return acc / cnt, cnt, ms

    run("float32")  # warm-ups: cuDNN's algorithms, allocator growth
    f32, cnt32, ms32 = run("float32")
    run("bfloat16")
    _zero_counts()
    b16, cnt16, ms16 = run("bfloat16")
    counts, by_dtype = _counts(), _dtype_counts()
    with plain_path():
        plain, _, plain_ms = run("bfloat16")
    if not np.isfinite(b16).all() or cnt16.min() < 1 or (
            not np.array_equal(cnt16, cnt32)):
        raise AssertionError("bf16 predictor: non-finite map or counts that "
                             "differ from the fp32 run")
    scale = max(1.0, float(np.abs(plain).max()))
    err_plain = float(np.abs(b16 - plain).max())
    err_f32 = float(np.abs(b16 - f32).max())
    log(f"  bf16 predictor batch of 4 (volume {BF16_PREDICT_VOLUME}): "
        f"{ms16:.1f} ms (fp32 {ms32:.1f} ms, plain bf16 {plain_ms:.1f} ms); "
        f"map vs plain bf16 {err_plain:.3e} (limit {BF16_MAP_TOL} x "
        f"{scale:.3f}), vs fp32 {err_f32:.3e} (limit {BF16_FP32_MAP_TOL} x "
        f"{scale:.3f}); launches {counts}, by dtype {by_dtype}")
    convs = 2 * (2 * cfg["model"]["num_levels"] - 1)
    # the first SingleConv reads the float32 image: GroupNorm module, cuDNN
    want = {"gcr_conv3d": convs - 1, "gn_stats": convs, "gn_affine": 1,
            "gn_bwd_reduce": 0, "gn_bwd_dx": 0, "overlap_add": 1}
    if counts != want or by_dtype["gcr_conv3d"]["bfloat16"] != convs - 1:
        raise AssertionError(f"bf16 predictor batch: {counts} {by_dtype}, "
                             f"want {want}, kernel 2 in bf16")
    if err_plain > BF16_MAP_TOL * scale or err_f32 > BF16_FP32_MAP_TOL * scale:
        raise AssertionError(f"bf16 predictor map: {err_plain:.3e} from the "
                             f"plain path, {err_f32:.3e} from fp32")
    return {"launches": counts, "by_dtype": by_dtype, "ms": ms16,
            "fp32_ms": ms32, "plain_ms": plain_ms, "err": err_plain}


def phase_train_bf16(seed: int, workdir: str, fp32_step_ms: float):
    """(a) phase 9's configuration with ``model.dtype: bfloat16``; (b) and
    (c) bench.py's bf16 3D rows, each through UNetTrainer on the kernel
    path and the plain path; the bf16 predictor batch; kernel 2 in bf16 at
    (a)'s shapes."""
    import numpy as np
    import torch

    from mdeical_image_segmentation_tpu_torch.data.loaders import VolumeLoader

    out = {"runs": {}, "launches": {}, "by_dtype": {}}

    def note(label, rec, plain_rec, by_dtype, peak, plain_peak, batch):
        step = _steady(rec)
        plain_step = _steady(plain_rec)
        out["runs"][label] = {"step_ms": step, "plain_step_ms": plain_step,
                              "patches_per_s": batch * 1e3 / step,
                              "peak_gib": peak, "plain_peak_gib": plain_peak}
        for k, v in by_dtype.items():
            tot = out["by_dtype"].setdefault(k, {"float32": 0, "bfloat16": 0})
            for d, n in v.items():
                tot[d] += n
        log(f"[phase 15] {label}: step {step:.1f} ms (median of steps 3+), "
            f"{batch * 1e3 / step:.2f} patches/s, peak {peak:.2f} GiB; plain "
            f"path {plain_step:.1f} ms, peak {plain_peak:.2f} GiB; launches "
            f"by dtype {by_dtype}")
        for k in ("gcr_conv3d", "gn_stats", "gn_affine", "gn_bwd_reduce",
                  "gn_bwd_dx"):
            if by_dtype[k]["bfloat16"] == 0:
                raise AssertionError(f"{label}: {k} never launched in bf16")

    # (a) phase 9's configuration in bf16
    setup = UNet3DTraining(seed, os.path.join(workdir, "bf16_a"))
    model_cfg = {**setup.model_cfg, "dtype": "bfloat16"}
    batch = setup.batch_size

    def loaders_a():
        return {"train": VolumeLoader(setup.train_ds, batch, shuffle=True,
                                      seed=seed, drop_last=True),
                "val": VolumeLoader(setup.val_ds, batch)}

    convs = 2 * (2 * model_cfg["num_levels"] - 1)
    want = _per_step(convs, 0)
    want["gcr_conv3d"] = want["gn_bwd_dx"] = convs - 1  # the first conv's
    log(f"[phase 15] (a) {model_cfg}, batch {batch}, patch 80x170x170, "
        f"{BF16_STEPS} steps kernel path, 3 plain")
    rec, plain_rec, by_dtype, peak, plain_peak = _paired_runs(
        "bf16_a", model_cfg, setup.cfg, loaders_a, setup.checkpoint, workdir,
        BF16_STEPS, 3, want)
    _compare_runs("bf16 UNet3D (a)", rec, plain_rec, 3, BF16_LOSS_TOLS,
                  BF16_GRAD_NORM_TOL)
    note("(a) phase 9's UNet3D in bf16", rec, plain_rec, by_dtype, peak,
         plain_peak, batch)
    out["launches"]["a"] = by_dtype
    log(f"[phase 15] (a) bf16 step {_steady(rec):.1f} ms against phase 9's "
        f"fp32 step {fp32_step_ms:.1f} ms in this call")
    out["fp32_step_ms"] = fp32_step_ms
    shapes = _bf16_gcr_shapes(
        model_cfg, setup.cfg["loaders"]["train"]["slice_builder"][
            "patch_shape"], batch)

    # (b), (c): bench.py's rows on its own batches
    rs = np.random.RandomState(0)
    x = rs.rand(BENCH_3D_BATCH, *BENCH_3D_PATCH, 1).astype(np.float32)
    y = (x > 0.5).astype(np.float32)
    for (label, cfg_m, steps, plain_steps), tag in zip(BENCH_3D_ROWS, "bc"):
        ckpt = _initial_checkpoint(cfg_m, seed, workdir, f"bf16_{tag}_init")
        per = (_per_step(2 * (2 * cfg_m["num_levels"] - 1), 0)
               if cfg_m["name"] == "UNet3D" else
               _per_step(2 * cfg_m["num_levels"] - 1,
                         2 * cfg_m["num_levels"] - 1, gcr_dx=False))
        if cfg_m["name"] == "UNet3D":
            per["gcr_conv3d"] = per["gn_bwd_dx"] = per["gcr_conv3d"] - 1
        log(f"[phase 15] ({tag}) bench.py's {label}: {cfg_m}, batch "
            f"{BENCH_3D_BATCH}, RandomState(0).rand, y = x > 0.5; {steps} "
            f"steps, {plain_steps} plain")
        rec, plain_rec, by_dtype, peak, plain_peak = _paired_runs(
            f"bf16_{tag}", cfg_m, BENCH_3D_CFG,
            lambda: {"train": [(x, y)] * steps, "val": [(x, y)]}, ckpt,
            workdir, steps, plain_steps, per)
        _compare_runs(f"bf16 {label}", rec, plain_rec, min(3, plain_steps),
                      BF16_LOSS_TOLS, BF16_GRAD_NORM_TOL)
        note(f"({tag}) {label}", rec, plain_rec, by_dtype, peak, plain_peak,
             BENCH_3D_BATCH)
        out["launches"][tag] = by_dtype
    out["predict"] = _bf16_predictor_batch(seed)
    out["k2"] = phase_bf16_forward_convs(seed, shapes)
    return out


def phase_device_cache(seed: int, workdir: str):
    """bench.py's unet3d_e2e_train_device_cache configuration through
    ``create_trainer(...).fit()``: one warm epoch and 3 timed, with
    ``device_cache: true`` and with the host loader; then the yml's
    pipeline with ``device_cache: true``, which must fall back."""
    import copy
    import logging

    import numpy as np
    import torch

    from mdeical_image_segmentation_tpu_torch.data import loaders as loaders_mod
    from mdeical_image_segmentation_tpu_torch.train.trainer3d import (
        create_trainer,
    )

    rs = np.random.RandomState(0)
    raw = rs.rand(*DC_VOLUME).astype(np.float32)
    files = {}
    for name, sl in (("train", slice(None)), ("val", slice(0, 64))):
        files[name] = os.path.join(workdir, f"dc_{name}.h5")
        write_h5_volume(files[name], raw[sl], (raw[sl] > 0.6).astype(
            np.uint8))

    def phase(name):
        tt = {"name": "ToTensor", "expand_dims": True}
        return {"transformer": {"raw": [{"name": "Standardize"},
                                        {"name": "RandomFlip"}, tt],
                                "label": [{"name": "RandomFlip"}, tt]},
                "slice_builder": {"name": "SliceBuilder",
                                  "patch_shape": list(BENCH_3D_PATCH),
                                  "stride_shape": list(BENCH_3D_PATCH),
                                  "skip_shape_check": True},
                "file_paths": [files[name]]}

    base = {
        "device": DEVICE, "seed": seed,
        "model": {"name": "UNet3D", "in_channels": 1, "out_channels": 1,
                  "f_maps": 32, "num_levels": 4, "layer_order": "gcr",
                  "num_groups": 8, "final_sigmoid": True},
        "loss": {"name": "BCEDiceLoss"}, "eval_metric": {"name": "MeanIoU"},
        "optimizer": {"name": "Adam", "learning_rate": 2e-4},
        "trainer": {"max_num_epochs": 1, "max_num_iterations": 10**9,
                    "validate_after_iters": 10**9, "log_after_iters": 10**9,
                    "skip_train_validation": True},
        "loaders": {"dataset": "StandardHDF5Dataset",
                    "batch_size": BENCH_3D_BATCH, "num_workers": 2,
                    "train": phase("train"), "val": phase("val")}}
    results = {}
    for device_cache in (True, False):
        cfg = copy.deepcopy(base)
        cfg["loaders"]["device_cache"] = device_cache
        cfg["trainer"]["checkpoint_dir"] = os.path.join(
            workdir, f"dc_{device_cache}")
        trainer = create_trainer(cfg)
        loader = trainer.loaders["train"]
        if device_cache and not getattr(loader, "is_device_cached", False):
            raise AssertionError("device_cache: true fell back to the host "
                                 "loader on the bench configuration")
        waits = []
        trainer.loaders["train"] = _TimedLoader(loader, waits)
        trainer.fit()  # the warm epoch
        torch.cuda.synchronize()
        n0 = trainer.num_iterations
        waits.clear()
        _zero_counts()
        trainer.max_num_epochs = 1 + DC_TIMED_EPOCHS
        t0 = time.perf_counter()
        trainer.fit()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        steps = trainer.num_iterations - n0
        launches = _counts()
        per = _per_step(2 * (2 * 4 - 1), 0)
        if steps != 4 * DC_TIMED_EPOCHS or launches != {
                k: v * steps for k, v in per.items()}:
            raise AssertionError(f"device_cache={device_cache}: {steps} "
                                 f"steps, launches {launches}")
        key = "device_cache" if device_cache else "host_loader"
        results[key] = {"ms_per_step": dt / steps * 1e3,
                        "patches_per_s": steps * BENCH_3D_BATCH / dt,
                        "wait_ms": statistics.median(waits),
                        "wait_max_ms": max(waits), "launches": launches,
                        "nbytes": getattr(loader, "nbytes", None)}
        log(f"[phase 16] {key}: {steps} steps in {dt:.3f} s, "
            f"{dt / steps * 1e3:.1f} ms a step, "
            f"{steps * BENCH_3D_BATCH / dt:.2f} patches/s; loader wait per "
            f"batch median {statistics.median(waits):.2f} ms, max "
            f"{max(waits):.2f} ms ({', '.join(f'{w:.1f}' for w in waits)})"
            + (f"; cache {loader.nbytes / 2**20:.1f} MiB on the device"
               if device_cache else ""))
        if not device_cache:
            loader.close()
        trainer.loaders["val"].close()
        del trainer, loader
        torch.cuda.empty_cache()

    # configs/unet3d_train.yml with device_cache: true runs on the host
    ycfg = read_yaml_subset(TRAIN_YML)
    ylabel = foreground_label(raw)
    for name, sl in (("yml_train", slice(None)), ("yml_val", slice(0, 80))):
        files[name] = os.path.join(workdir, f"{name}.h5")
        write_h5_volume(files[name], raw[sl], ylabel[sl])
    ycfg["loaders"]["device_cache"] = True
    ycfg["loaders"]["train"]["file_paths"] = [files["yml_train"]]
    ycfg["loaders"]["val"]["file_paths"] = [files["yml_val"]]

    class _Warnings(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.messages = []

        def emit(self, record):
            self.messages.append(record.getMessage())

    handler = _Warnings()
    loaders_mod.logger.addHandler(handler)
    try:
        got = loaders_mod.get_train_loaders(ycfg, device=torch.device(DEVICE))
    finally:
        loaders_mod.logger.removeHandler(handler)
    fell_back = [m for m in handler.messages if "falling back" in m]
    if not isinstance(got["train"], loaders_mod.VolumeLoader) or not any(
            "RandomRotate" in m or "ElasticDeformation" in m
            for m in fell_back):
        raise AssertionError(f"the yml with device_cache: true gave "
                             f"{type(got['train']).__name__}, warnings "
                             f"{handler.messages}")
    log(f"[phase 16] configs/unet3d_train.yml with device_cache: true: "
        f"{type(got['train']).__name__} and the warning {fell_back[0]!r}")
    got["train"].close()
    got["val"].close()
    results["launches"] = results["device_cache"]["launches"]
    return results


def _family_loaders(volume_shape, patch, batch, seed):
    from mdeical_image_segmentation_tpu_torch.data.loaders import VolumeLoader

    raw = seeded_volume(volume_shape, seed)
    ds = _PatchDataset(raw, _smooth_label(raw), patch, patch)

    def make():
        return {"train": VolumeLoader(ds, batch, shuffle=True, seed=seed,
                                      drop_last=True),
                "val": VolumeLoader(ds, batch)}
    return make, ds


def _bcr_card_vs_cpu(seed: int, model_cfg, workdir: str):
    """One training step of the 'bcr' UNet3D at 32x64x64 from the same
    weights and batch on the card and on the CPU (fp32, TF32 off): the
    loss and the running statistics after the step."""
    import torch

    from mdeical_image_segmentation_tpu_torch.losses import (
        get_loss_criterion,
    )
    from mdeical_image_segmentation_tpu_torch.models import get_model

    raw = seeded_volume(BCR_CPU_PATCH, seed + 9)
    x = torch.from_numpy(raw)[None, ..., None]
    t = torch.from_numpy(_smooth_label(raw))[None, ..., None]
    x, t = torch.cat([x, x.flip(1)]), torch.cat([t, t.flip(1)])
    init = get_model(model_cfg, generator=torch.Generator().manual_seed(seed))
    state = {k: v.clone() for k, v in init.state_dict().items()}
    res = {}
    for device in (DEVICE, "cpu"):
        model = get_model(model_cfg, device=device)
        model.load_state_dict(state)
        model.train()
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        loss = get_loss_criterion({"loss": {"name": "BCEDiceLoss"}})(
            model(x.to(device)), t.to(device))
        loss.backward()
        opt.step()
        stats = torch.cat([b.detach().cpu().flatten()
                           for n, b in model.named_buffers()
                           if n.endswith(("running_mean", "running_var"))])
        res[device] = (loss.item(), stats)
    (lk, sk), (lc, sc) = res[DEVICE], res["cpu"]
    loss_err, stats_err = abs(lk - lc) / abs(lc), _stats_rel(sk, sc)
    log(f"  'bcr' step at {BCR_CPU_PATCH}, batch 2, card vs CPU: loss "
        f"{lk:.7f} / {lc:.7f} (rel {loss_err:.2e}), running statistics "
        f"rel {stats_err:.2e} (limit {CPU_TOL} each)")
    if loss_err > CPU_TOL or stats_err > CPU_TOL:
        raise AssertionError("'bcr' card vs CPU beyond the limits")
    return loss_err, stats_err


def phase_family_and_remat(seed: int, workdir: str):
    """ResidualUNetSE3D, UNet3D 'bcr', UNet2D and ResidualUNet2D: 3 steps
    each on the kernel path and the plain path; the 'bcr' step card vs
    CPU; phase 9's configuration under remat ('save_convs_norms' and None)
    against remat off, to the bit."""
    import numpy as np
    import torch

    out = {"runs": {}, "launches": {}}
    cfg = read_yaml_subset(TRAIN_YML)
    for label, model_cfg, volume, patch, batch in FAMILY_ROWS:
        make, ds = _family_loaders(volume, patch, batch, seed + 7)
        levels = model_cfg["num_levels"]
        if "b" in model_cfg["layer_order"]:
            want = {k: 0 for k in KERNELS_3D}
        elif model_cfg["name"].startswith("Residual"):
            fused = 0 if model_cfg["name"].endswith("2D") else 2 * levels - 1
            want = _per_step(fused, 2 * (2 * levels - 1) - fused,
                             gcr_dx=False)
        else:  # UNet2D: every GroupNorm is a module
            want = _per_step(0, 2 * (2 * levels - 1))
        ckpt = _initial_checkpoint(model_cfg, seed, workdir,
                                   f"family_{len(out['runs'])}")
        log(f"[phase 17] {label}: {model_cfg}, {len(ds)} patches of "
            f"{patch} from a seeded {volume} volume, batch {batch}; "
            f"{FAMILY_STEPS} steps each path; launches a step {want}")
        rec, plain_rec, by_dtype, peak, plain_peak = _paired_runs(
            f"family_{label}", model_cfg, cfg, make, ckpt, workdir,
            FAMILY_STEPS, FAMILY_STEPS, want)
        _compare_runs(label, rec, plain_rec, FAMILY_STEPS)
        out["runs"][label] = {"step_ms": _steady(rec, 1),
                              "plain_step_ms": _steady(plain_rec, 1),
                              "peak_gib": peak, "batch": batch}
        out["launches"][label] = _counts_from(rec)
        log(f"[phase 17] {label}: step {_steady(rec, 1):.1f} ms (median of "
            f"steps 2-3; plain {_steady(plain_rec, 1):.1f}), peak "
            f"{peak:.2f} GiB")
        if "b" in model_cfg["layer_order"]:
            out["bcr_cpu"] = _bcr_card_vs_cpu(seed, model_cfg, workdir)

    # remat on phase 9's configuration: deterministic cuDNN, every loss and
    # parameter equal to the bit to remat off
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
           torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    # MaxPool3d's backward has no deterministic twin and warns: its windows
    # do not overlap here, so each gradient element gets one addition
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        setup = UNet3DTraining(seed, os.path.join(workdir, "remat"))
        base_cfg = setup.model_cfg
        runs = {}
        convs = 2 * (2 * base_cfg["num_levels"] - 1)
        for policy in ("off", "save_convs_norms", None):
            setup.model_cfg = (base_cfg if policy == "off" else
                               {**base_cfg, "remat": True,
                                "remat_policy": policy})
            trainer = setup.trainer(f"remat_{policy}",
                                    max_num_iterations=REMAT_STEPS - 1,
                                    validate_after_iters=10**9,
                                    log_after_iters=10**9)
            rec = []
            _instrument(trainer, rec)
            torch.cuda.synchronize()
            gc.collect()
            torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            trainer.fit()
            peak = torch.cuda.max_memory_allocated() / 2**30
            launches = _counts()
            want = _per_step(convs, 0)
            if policy is None:  # the forward runs again in the backward
                want["gcr_conv3d"] *= 2
                want["gn_stats"] *= 2
            per = {k: v * REMAT_STEPS for k, v in want.items()}
            if launches != per:
                raise AssertionError(f"remat {policy}: launches {launches},"
                                     f" want {per}")
            params = [p.detach().clone() for p in
                      trainer.model.parameters()]
            runs[str(policy)] = {"losses": [r["loss"] for r in rec],
                                 "ms": _steady(rec, 1), "peak_gib": peak,
                                 "params": params, "launches": launches}
            log(f"[phase 17] remat {policy}: losses "
                f"{[f'{r:.9f}' for r in runs[str(policy)]['losses']]}, "
                f"step {_steady(rec, 1):.1f} ms, peak {peak:.2f} GiB, "
                f"launches {launches}")
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
        off = runs["off"]
        for policy in ("save_convs_norms", "None"):
            r = runs[policy]
            same = r["losses"] == off["losses"] and all(
                torch.equal(a, b) for a, b in zip(r["params"],
                                                  off["params"]))
            if not same:
                raise AssertionError(f"remat {policy} differs from remat off"
                                     f" ({r['losses']} vs {off['losses']})")
        log("[phase 17] remat save_convs_norms and None: every loss and "
            "parameter equal to remat off, bit for bit")
        out["remat"] = {k: {kk: vv for kk, vv in v.items()
                            if kk != "params"} for k, v in runs.items()}
        out["launches"]["remat"] = {
            k: sum(r["launches"][k] for r in runs.values())
            for k in KERNELS_3D}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
            det[0], det[1])
        torch.use_deterministic_algorithms(det[2])
    if not np.isfinite([r["ms"] for r in runs.values()]).all():
        raise AssertionError("remat: non-finite step times")
    return out


# ---------------------------------------------------------------------------
# Phase 18: int8 post-training quantization (W8A8) on the card
# ---------------------------------------------------------------------------

PEAK_INT8 = 1979e12      # published dense int8 tensor-core rate, H100 SXM
# bench.py:185-225 (bench_int8_infer): UNet3D f_maps 32, 4 levels, 'gcr',
# bf16, batch 2 at 64x128x128, x = RandomState(0).rand, calibrated on x
BENCH_INT8_MODEL = {"name": "UNet3D", "in_channels": 1, "out_channels": 1,
                    "f_maps": 32, "num_levels": 4, "layer_order": "gcr",
                    "dtype": "bfloat16"}
BENCH_INT8_X = (2, 64, 128, 128, 1)
INT8_BLOCKS = 5          # (b): best of this many blocks ...
INT8_BLOCK_FORWARDS = 3  # ... of this many forwards each
# tests/test_int8_fidelity.py: three seeded blob volumes, UNet3D f_maps 16,
# 2 levels, 'gcr', 60 iterations, patch 16x32x32, calib_batches 2
FIDELITY_VOLUME = (24, 48, 48)
FIDELITY_MODEL = {"name": "UNet3D", "in_channels": 1, "out_channels": 1,
                  "f_maps": 16, "num_levels": 2, "layer_order": "gcr",
                  "final_sigmoid": True}
FIDELITY_PATCH = [16, 32, 32]
FIDELITY_DICE = 0.5      # the float model must have learned the task
FIDELITY_DELTA = 0.05    # |dice_float - dice_int8|
FIDELITY_AGREE = 0.97    # voxel agreement, float vs int8
INT8_SERVE_BASE, INT8_SERVE_RES = 64, 256  # (e) phase 2's bundle
INT8_SERVE_EQUAL = 0.999  # (e) served int8 masks vs the plain int8 forward
INT8_SERVE_AGREE = 0.98   # (e) served int8 masks vs the float masks
INT8_PLAIN_MAX_NUMEL = 2 ** 28  # (a) the plain version at N = 1 above this
# (a) beside the models' shapes: a 1x3x3 window with Ci = 16 mod 32 and odd
# H, W; Co not a multiple of 64; ragged Ci (the element-wise gather); a 2D
# Ci = 8 conv from bf16 into fp32; a 3x3x3 conv without padding
INT8_RAGGED = (
    ("ragged", (1, 5, 19, 23, 48), "float32", (24, 48, 1, 3, 3),
     ((0, 0), (1, 1), (1, 1)), "float32", True),
    ("ragged", (2, 3, 9, 17, 16), "bfloat16", (70, 16, 3, 3, 3),
     ((1, 1), (1, 1), (1, 1)), "bfloat16", False),
    ("ragged", (1, 7, 11, 13, 40), "float32", (5, 40, 3, 3, 3),
     ((1, 1), (1, 1), (1, 1)), "float32", True),
    ("ragged", (3, 9, 31, 8), "bfloat16", (65, 8, 3, 3),
     ((1, 1), (1, 1)), "float32", True),
    ("ragged", (2, 6, 6, 6, 32), "float32", (16, 32, 3, 3, 3),
     ((0, 0), (0, 0), (0, 0)), "float32", True),
)
# (a) the halo loop's edges: H and W not multiples of the tile, Co below
# the channel tile and not a multiple of 8, D = 1 with KD = 3, Ci = 16 mod
# 32, a ragged second channel tile (128 and 256 channels); the gather
# loop's 8-channel tile, by 16-byte copies and by bytes
INT8_EDGE = (
    ("edge", (2, 1, 13, 21, 48), "bfloat16", (20, 48, 3, 3, 3),
     ((1, 1), (1, 1), (1, 1)), "bfloat16", True),
    ("edge", (4, 6, 37, 45, 48), "float32", (20, 48, 3, 3, 3),
     ((1, 1), (1, 1), (1, 1)), "float32", True),
    ("edge", (1, 4, 9, 40, 16), "bfloat16", (7, 16, 3, 3, 3),
     ((1, 1), (1, 1), (1, 1)), "float32", False),
    ("edge", (3, 37, 45, 80), "float32", (132, 80, 3, 3),
     ((1, 1), (1, 1)), "float32", True),
    ("edge", (4, 6, 40, 40, 48), "float32", (100, 48, 3, 3, 3),
     ((1, 1), (1, 1), (1, 1)), "bfloat16", True),
    ("edge", (2, 9, 32, 64, 32), "float32", (300, 32, 3, 3, 3),
     ((1, 1), (1, 1), (1, 1)), "float32", True),
    ("edge", (2, 6, 10, 14, 32), "float32", (3, 32, 1, 1, 1),
     ((0, 0), (0, 0), (0, 0)), "bfloat16", True),
    ("edge", (2, 6, 10, 14, 24), "bfloat16", (5, 24, 1, 1, 1),
     ((0, 0), (0, 0), (0, 0)), "float32", True),
)
# the two kernels of an int8_conv call, by name: the quantize pass, then
# the conv (int8_conv_wgmma_kernel or int8_conv_gather_kernel)
INT8_KINDS = ("tpuseg_int8::int8_quantize", "tpuseg_int8::int8_conv_")
# (b) int8 forward vs the plain int8 forward, of max |y|: the same GroupNorm
# kernels feed both, so the convs see the same inputs and give the same
# integers
INT8_OUT_TOL = 1e-3


def _int8_counts():
    from mdeical_image_segmentation_tpu_torch.ops import quant

    return {**_counts(), "int8_conv": quant.int8_conv.launches,
            "int8_quantize": quant.int8_quantize.launches}


def _zero_int8_counts():
    from mdeical_image_segmentation_tpu_torch.ops import quant

    _zero_counts()
    quant.int8_conv.launches = 0
    quant.int8_quantize.launches = 0


class plain_int8:
    """Within this block the int8 convs run ``int8_conv_reference`` (an
    exact float64 conv of the int8 values and the same float32 epilogue) on
    the card; every other op, the GroupNorm kernels included, is as it was,
    so the convs see the same inputs."""

    def __enter__(self):
        from mdeical_image_segmentation_tpu_torch.ops import quant

        self.saved = quant.int8_conv
        quant.int8_conv = quant.int8_conv_reference
        return self

    def __exit__(self, *exc):
        from mdeical_image_segmentation_tpu_torch.ops import quant

        quant.int8_conv = self.saved


def _record_int8_shapes(model, shapes: set, tag: str):
    """Forward pre-hooks noting every quantized conv's call in int8 mode:
    (tag, x shape, x dtype, weight shape, pads, out dtype, bias)."""
    from mdeical_image_segmentation_tpu_torch.models.layers2d import TorchConv
    from mdeical_image_segmentation_tpu_torch.ops import quant

    def hook(mod, args):
        x = args[0]
        if quant.mode() == "int8" and quant.quantizable(mod.kernel_size,
                                                        x.shape[-1]):
            shapes.add((tag, tuple(x.shape), str(x.dtype)[6:],
                        tuple(mod.weight.shape), tuple(mod._pads(x)),
                        str(mod.dtype or x.dtype)[6:], mod.bias is not None))

    return [m.register_forward_pre_hook(hook) for m in model.modules()
            if isinstance(m, TorchConv)]


def _best_ms(fn, blocks=INT8_BLOCKS, per_block=INT8_BLOCK_FORWARDS):
    """ms of one call: the best of ``blocks`` CUDA-event windows of
    ``per_block`` calls each, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(blocks):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(per_block):
            fn()
        e.record()
        torch.cuda.synchronize()
        best = min(best, s.elapsed_time(e) / per_block)
    return best


def _int8_bench_row(seed: int, shapes: set):
    """(b) bench.py's int8 row as the port runs it."""
    import numpy as np
    import torch

    from mdeical_image_segmentation_tpu_torch.models import get_model
    from mdeical_image_segmentation_tpu_torch.ops import quant

    model = get_model(BENCH_INT8_MODEL,
                      generator=torch.Generator().manual_seed(seed))
    model = model.to(DEVICE).eval()
    x = torch.from_numpy(np.random.RandomState(0).rand(*BENCH_INT8_X)
                         .astype(np.float32)).to(DEVICE)
    scales = quant.calibrate(model, model, [x])

    def float_fwd():
        return model(x)

    def int8_fwd():
        with quant.quant_mode("int8", scales, model):
            return model(x)

    with torch.inference_mode():
        y_f = float_fwd().float()
        handles = _record_int8_shapes(model, shapes, "bench")
        torch.cuda.synchronize()
        _zero_int8_counts()
        y_q = int8_fwd().float()
        torch.cuda.synchronize()
        launches = _int8_counts()
        for h in handles:
            h.remove()
        with plain_int8():
            y_p = int8_fwd().float()
        # in turns: float, int8, int8, float
        f1, q1 = _best_ms(float_fwd), _best_ms(int8_fwd)
        q2, f2 = _best_ms(int8_fwd), _best_ms(float_fwd)
    for name, y in (("float", y_f), ("int8", y_q), ("plain int8", y_p)):
        if not torch.isfinite(y).all() or y.shape != (*BENCH_INT8_X[:-1], 1):
            raise AssertionError(f"(b) {name} forward: {tuple(y.shape)}, "
                                 "non-finite or wrong shape")
    gap_plain = float((y_q - y_p).abs().max() / y_p.abs().max())
    gap_float = float((y_q - y_f).abs().max() / y_f.abs().max())
    agree = float(((y_q > 0) == (y_f > 0)).float().mean())
    float_ms, int8_ms = min(f1, f2), min(q1, q2)
    log(f"[phase 18] (b) bench.py int8 row (UNet3D f_maps 32, bf16, batch 2,"
        f" 64x128x128): float forward (kernel 2) {float_ms:.3f} ms "
        f"({f1:.3f} / {f2:.3f}), int8 forward {int8_ms:.3f} ms ({q1:.3f} / "
        f"{q2:.3f}); int8 / float {int8_ms / float_ms:.3f}; launches per "
        f"int8 forward {launches}; int8 vs plain int8 (same GroupNorm "
        f"kernels) max |Δ| {gap_plain:.3e} of max |y|; int8 vs float "
        f"{gap_float:.3e} of max |y|, sign agreement {agree:.4f}")
    if gap_plain > INT8_OUT_TOL:
        raise AssertionError(f"(b) int8 forward differs from the plain int8 "
                             f"forward by {gap_plain:.3e} of max |y|")
    if (launches["int8_conv"] != 14 or launches["int8_quantize"] != 14
            or launches["gcr_conv3d"] != 0):
        raise AssertionError(f"(b) {launches}: want 14 int8_conv and 14 "
                             "int8_quantize launches (13 'gcr' convs and "
                             "the final conv) and no kernel 2")
    del model
    torch.cuda.empty_cache()
    return {"float_ms": float_ms, "int8_ms": int8_ms,
            "gap_plain": gap_plain, "gap_float": gap_float,
            "launches": launches["int8_conv"], "counts": launches}


def _instrument_int8(pred, rec):
    """Time each batch of a predictor (synchronised host clock) and note
    its mode and the launches it made."""
    import torch

    orig = pred._predict_batch_device

    def timed(input):
        mode = ("float" if pred.quantize is None else
                "calib" if pred._calib_seen < pred.calib_batches else "int8")
        torch.cuda.synchronize()
        before, t0 = _int8_counts(), time.perf_counter()
        out = orig(input)
        torch.cuda.synchronize()
        after = _int8_counts()
        rec.append((mode, (time.perf_counter() - t0) * 1e3,
                    {k: after[k] - before[k] for k in after}))
        return out

    pred._predict_batch_device = timed


def _int8_predict_cli(seed: int, workdir: str, shapes: set):
    """(c) cli/predict3d.py on a copy of configs/unet3d_predict.yml with
    ``quantize: int8``, phase 3's seeded weights and volume, beside the
    float yml."""
    import numpy as np
    import torch

    from mdeical_image_segmentation_tpu_torch.cli import predict3d
    from mdeical_image_segmentation_tpu_torch.infer import (
        predictor as predictor_lib,
    )
    from mdeical_image_segmentation_tpu_torch.models import get_model
    from mdeical_image_segmentation_tpu_torch.train import save_checkpoint
    from mdeical_image_segmentation_tpu_torch.utils import hdf5
    from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
        state_dict_to_flax,
    )

    text = open(PREDICT_YML).read()
    line = "  # quantize: int8"
    if line not in text:
        raise AssertionError(f"{PREDICT_YML} no longer documents '{line}'")
    int8_yml = os.path.join(workdir, "unet3d_predict_int8.yml")
    with open(int8_yml, "w") as f:
        f.write(text.replace(line, "  quantize: int8", 1))
    cfg = read_yaml_subset(PREDICT_YML)
    ckpt = save_checkpoint(
        {"model_state_dict": state_dict_to_flax(get_model(
            cfg["model"], generator=torch.Generator().manual_seed(seed)
        ).state_dict()), "best_eval_score": 0.0, "num_iterations": 0},
        True, os.path.join(workdir, "int8_ckpt"))
    raw = seeded_volume(VOLUME_3D, seed)
    path = os.path.join(workdir, "int8_volume.h5")
    write_h5_volume(path, raw)

    get = predictor_lib.get_predictor
    runs = {}
    for name, yml in (("float", PREDICT_YML), ("int8", int8_yml)):
        rec, made = [], []
        handles = []

        def instrumented(model, output_dir, config, **kw):
            p = get(model, output_dir, config, **kw)
            _instrument_int8(p, rec)
            if name == "int8":
                handles.extend(_record_int8_shapes(model, shapes,
                                                   "predictor"))
            made.append(p)
            return p

        out_dir = os.path.join(workdir, f"pred_{name}")
        argv = ["--config", yml, "--model_path", ckpt, "--output_dir",
                out_dir, "--loaders.test.file_paths", repr([path]),
                "--device", DEVICE]
        predictor_lib.get_predictor = instrumented
        try:
            torch.cuda.synchronize()
            _zero_int8_counts()
            t0 = time.perf_counter()
            predict3d.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _int8_counts()
        finally:
            predictor_lib.get_predictor = get
            for h in handles:
                h.remove()
        with hdf5.File(os.path.join(out_dir, "int8_volume_predictions.h5")
                       ) as f:
            got = f["predictions"][:]
        runs[name] = {"rec": rec, "wall": wall, "launches": launches,
                      "map": got, "quantize": made[0].quantize}
        for i, (mode, ms, n) in enumerate(rec):
            log(f"  {name} batch {i} ({mode}): {ms:.1f} ms, launches {n}")
        del made
        torch.cuda.empty_cache()
    f_run, q_run = runs["float"], runs["int8"]
    if q_run["quantize"] != "int8" or f_run["quantize"] is not None:
        raise AssertionError("(c) the int8 yml did not reach the predictor")
    modes = [m for m, _, _ in q_run["rec"]]
    if modes != ["calib", "int8"]:
        raise AssertionError(f"(c) batch modes {modes}: want calib, int8")
    for mode, _, n in q_run["rec"]:
        want = {"calib": 0, "int8": 14}[mode]
        if (n["int8_conv"] != want or n["int8_quantize"] != want
                or n["gcr_conv3d"] != 0 or n["gn_stats"] != 14
                or n["gn_affine"] != 14):
            raise AssertionError(f"(c) {mode} batch {n}: want {want} "
                                 "int8_conv and int8_quantize, 14 gn_stats "
                                 "and 14 gn_affine launches, no kernel 2")
    if q_run["launches"]["overlap_add"] != 2:
        raise AssertionError(f"(c) {q_run['launches']}: want one overlap-add "
                             "per batch")
    fmap, qmap = f_run["map"], q_run["map"]
    if fmap.shape != qmap.shape or not np.isfinite(qmap).all():
        raise AssertionError(f"(c) int8 map {qmap.shape} vs float "
                             f"{fmap.shape}, or non-finite")
    gap = float(np.abs(qmap - fmap).max())
    scale = float(np.abs(fmap).max())
    f_ms = [ms for _, ms, _ in f_run["rec"]]
    calib_ms = [ms for m, ms, _ in q_run["rec"] if m == "calib"]
    int8_ms = [ms for m, ms, _ in q_run["rec"] if m == "int8"]
    log(f"[phase 18] (c) predict3d, UNet3D f_maps 64 fp32, batch 4 of "
        f"112x234x234: float batches {[round(v, 1) for v in f_ms]} ms, "
        f"int8 run calib batch {[round(v, 1) for v in calib_ms]} ms, int8 "
        f"batch {[round(v, 1) for v in int8_ms]} ms; whole run float "
        f"{f_run['wall']:.2f} s, int8 {q_run['wall']:.2f} s; int8 map vs "
        f"float map max |Δ| {gap:.4e} (max |float| {scale:.4f}, mean |Δ| "
        f"{float(np.abs(qmap - fmap).mean()):.4e})")
    return {"float_ms": f_ms, "calib_ms": calib_ms, "int8_ms": int8_ms,
            "gap": gap, "scale": scale,
            "launches": q_run["launches"]["int8_conv"],
            "counts": q_run["launches"]}


def fidelity_volume(path, shape, n_blobs, seed):
    """tests/test_int8_fidelity.py's blob phantom: ``n_blobs`` Gaussian
    blobs, label = field > 0.5, raw = field + 0.2·noise, written with the
    port's HDF5 codec; returns the label."""
    import numpy as np

    rs = np.random.RandomState(seed)
    d, h, w = shape
    zz, yy, xx = np.meshgrid(np.arange(d), np.arange(h), np.arange(w),
                             indexing="ij")
    field = np.zeros(shape, np.float32)
    for _ in range(n_blobs):
        c = rs.rand(3) * [d, h, w]
        r = rs.uniform(3.0, 7.0)
        d2 = ((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2) / r ** 2
        field = np.maximum(field, np.exp(-d2).astype(np.float32))
    label = (field > 0.5).astype(np.uint8)
    raw = field + rs.randn(*shape).astype(np.float32) * 0.2
    write_h5_volume(path, raw, label)
    return label


def _fidelity_phase(fp, patch, stride):
    return {"transformer": {"raw": [{"name": "Standardize"},
                                    {"name": "ToTensor", "expand_dims": True}],
                            "label": [{"name": "ToTensor",
                                       "expand_dims": True}]},
            "slice_builder": {"name": "SliceBuilder", "patch_shape": patch,
                              "stride_shape": stride,
                              "skip_shape_check": True},
            "file_paths": [fp]}


def _dice(pred, gt):
    import numpy as np

    inter = float(np.logical_and(pred, gt).sum())
    return 2 * inter / max(float(pred.sum() + gt.sum()), 1.0)


def _int8_fidelity(workdir: str, shapes: set):
    """(d) tests/test_int8_fidelity.py's recipe on the card: train, then
    predict the held-out volume float and int8."""
    import numpy as np
    import torch

    from mdeical_image_segmentation_tpu_torch.data.loaders import (
        get_test_loaders,
    )
    from mdeical_image_segmentation_tpu_torch.infer import get_predictor
    from mdeical_image_segmentation_tpu_torch.models import get_model
    from mdeical_image_segmentation_tpu_torch.train import load_checkpoint
    from mdeical_image_segmentation_tpu_torch.train.trainer3d import (
        create_trainer,
    )
    from mdeical_image_segmentation_tpu_torch.utils import hdf5
    from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
        flax_to_state_dict,
    )

    root = os.path.join(workdir, "fidelity")
    os.makedirs(root, exist_ok=True)
    for name, seed in (("train", 0), ("val", 1)):
        fidelity_volume(f"{root}/{name}.h5", FIDELITY_VOLUME, 14, seed)
    gt = fidelity_volume(f"{root}/test.h5", FIDELITY_VOLUME, 14, 2)
    cfg = {
        "device": DEVICE,
        "model": FIDELITY_MODEL,
        "loss": {"name": "BCEDiceLoss"},
        "eval_metric": {"name": "DiceCoefficient"},
        "optimizer": {"name": "Adam", "learning_rate": 2e-3},
        "lr_scheduler": {"name": "ReduceLROnPlateau", "mode": "max",
                         "factor": 0.5, "patience": 10},
        "trainer": {"checkpoint_dir": f"{root}/ckpt", "max_num_epochs": 1000,
                    "max_num_iterations": 60, "validate_after_iters": 30,
                    "log_after_iters": 30},
        "loaders": {"dataset": "StandardHDF5Dataset", "batch_size": 1,
                    "train": _fidelity_phase(f"{root}/train.h5",
                                             FIDELITY_PATCH, [8, 16, 16]),
                    "val": _fidelity_phase(f"{root}/val.h5", FIDELITY_PATCH,
                                           FIDELITY_PATCH)},
    }
    t0 = time.perf_counter()
    create_trainer(cfg).fit()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    ms = load_checkpoint(f"{root}/ckpt/best_checkpoint.msgpack")[
        "model_state_dict"]
    model = get_model(FIDELITY_MODEL, device=DEVICE)
    model.load_state_dict(flax_to_state_dict(ms))
    model.eval()
    preds, launches = {}, {}
    for tag, pcfg in (("float", {"apply_activation": True}),
                      ("int8", {"apply_activation": True, "quantize": "int8",
                                "calib_batches": 2})):
        out_dir = f"{root}/pred_{tag}"
        os.makedirs(out_dir, exist_ok=True)
        config = {"model": FIDELITY_MODEL,
                  "predictor": dict(pcfg, name="StandardPredictor"),
                  "loaders": {"dataset": "StandardHDF5Dataset",
                              "batch_size": 2,
                              "test": _fidelity_phase(f"{root}/test.h5",
                                                      FIDELITY_PATCH,
                                                      [8, 16, 16])}}
        predictor = get_predictor(model, out_dir, config)
        handles = _record_int8_shapes(model, shapes, "fidelity")
        _zero_int8_counts()
        for loader in get_test_loaders(config):
            predictor(loader)
        torch.cuda.synchronize()
        counts = _int8_counts()
        launches[tag] = counts["int8_conv"]
        if counts["int8_quantize"] != counts["int8_conv"]:
            raise AssertionError(f"(d) {tag}: {counts}: want one "
                                 "int8_quantize launch per int8_conv")
        for h in handles:
            h.remove()
        with hdf5.File(f"{out_dir}/test_predictions.h5") as f:
            prob = f["predictions"][:]
        preds[tag] = (prob[0] if prob.ndim == 4 else prob) > 0.5
    d_f, d_q = _dice(preds["float"], gt), _dice(preds["int8"], gt)
    agree = float((preds["float"] == preds["int8"]).mean())
    log(f"[phase 18] (d) fidelity (UNet3D f_maps 16, 2 levels, 60 "
        f"iterations in {train_s:.1f} s): dice float {d_f:.4f}, int8 "
        f"{d_q:.4f}, |Δdice| {abs(d_f - d_q):.4f}, voxel agreement "
        f"{agree:.5f}; int8_conv launches {launches}")
    if d_f <= FIDELITY_DICE:
        raise AssertionError(f"(d) float dice {d_f:.4f} too low to judge "
                             "fidelity")
    if abs(d_f - d_q) >= FIDELITY_DELTA or agree <= FIDELITY_AGREE:
        raise AssertionError(f"(d) int8 fidelity: dice {d_f:.4f} vs "
                             f"{d_q:.4f}, agreement {agree:.5f}")
    if launches["float"] != 0 or launches["int8"] == 0:
        raise AssertionError(f"(d) int8_conv launches {launches}")
    del model
    torch.cuda.empty_cache()
    return {"dice_float": d_f, "dice_int8": d_q, "agree": agree,
            "launches": launches["int8"]}


def _int8_serving(seed: int, workdir: str, shapes: set):
    """(e) register_unet2d(quantize="int8", calib_batches=1) on phase 2's
    bundle beside the float model, 8 clients each."""
    import numpy as np
    import torch

    from mdeical_image_segmentation_tpu_torch.data.png2d import nearest_resize
    from mdeical_image_segmentation_tpu_torch.models import (
        UNetConfig,
        UNetModel,
    )
    from mdeical_image_segmentation_tpu_torch.ops import quant
    from mdeical_image_segmentation_tpu_torch.serve import (
        ModelRegistry,
        SegmentationServer,
    )
    from mdeical_image_segmentation_tpu_torch.utils import png

    res, max_batch, clients, per_client = INT8_SERVE_RES, 8, 8, 4
    config = UNetConfig(in_channels=1, out_channels=1, unet_type="UNet",
                        base_features=INT8_SERVE_BASE,
                        compute_dtype="bfloat16")
    bundle = os.path.join(workdir, "unet2d_base64_bf16")
    UNetModel(config, device="cpu",
              generator=torch.Generator().manual_seed(seed)
              ).save_pretrained(bundle)
    registry = ModelRegistry()
    t0 = time.time()
    registry.register_unet2d("float", bundle, resolution=res, device=DEVICE,
                             max_batch=max_batch)
    t1 = time.time()
    registry.register_unet2d("int8", bundle, resolution=res, device=DEVICE,
                             max_batch=max_batch, quantize="int8",
                             calib_batches=1)
    log(f"[phase 18] (e) registered float in {t1 - t0:.2f} s, int8 in "
        f"{time.time() - t1:.2f} s (warm-up of batches 1..{max_batch})")
    q_entry, f_entry = registry.get("int8"), registry.get("float")
    if q_entry.quant_scales:
        raise AssertionError("(e) the warm-up fed the served scales")

    rng = np.random.default_rng(seed)
    images, arrays = [], []
    for i in range(clients * per_client):
        h, w = ((256, 256), (200, 310), (384, 384), (97, 130))[i % 4]
        yy, xx = np.mgrid[:h, :w]
        blob = (((yy - h / 2) ** 2 + (xx - w / 3) ** 2) < (min(h, w) / 3) ** 2)
        grey = (blob * 150 + rng.integers(0, 60, (h, w))).astype(np.uint8)
        path = os.path.join(workdir, f"int8_scan_{i:02d}.png")
        png.write(path, grey)
        images.append(path)
        arrays.append(nearest_resize(grey[..., None], (res, res)))
    x = np.stack(arrays)

    # the first dispatched batch calibrates: the first 8 images, as one
    # device batch, before the clients come
    _zero_int8_counts()
    q_entry.forward(x[:max_batch])
    torch.cuda.synchronize()
    if (quant.int8_conv.launches != 0 or quant.int8_quantize.launches != 0
            or not q_entry.quant_scales):
        raise AssertionError("(e) the calibration batch launched int8 convs "
                             "or recorded no scales")
    model = UNetModel.from_pretrained(bundle, device=DEVICE)
    srv = SegmentationServer(registry,
                             output_dir=os.path.join(workdir, "int8_masks"),
                             max_batch=max_batch, max_wait_ms=5.0)
    port = srv.start(host="127.0.0.1", port=0).server_address[1]
    out = {}
    try:
        for name in ("float", "int8"):
            replies = [None] * len(images)
            lat = [0.0] * len(images)

            def client(k):
                for i in range(k, len(images), clients):
                    t = time.perf_counter()
                    replies[i] = _post(port, {"image_path": images[i],
                                              "model": name,
                                              "return": "mask"})
                    lat[i] = (time.perf_counter() - t) * 1e3

            occ0 = srv.engine.occupancy().get(name, {"batches": 0})["batches"]
            _zero_int8_counts()
            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            if any(t.is_alive() for t in threads):
                raise AssertionError("(e) a client did not finish in 600 s")
            batches = srv.engine.occupancy()[name]["batches"] - occ0
            launches = quant.int8_conv.launches
            if quant.int8_quantize.launches != launches:
                raise AssertionError(
                    f"(e) {name}: {quant.int8_quantize.launches} "
                    f"int8_quantize launches for {launches} int8_conv")
            masks = []
            for i, (status, body) in enumerate(replies):
                if status != 200 or body.get("status") != 200:
                    raise AssertionError(f"(e) {name} request {i}: {status}")
                masks.append(np.asarray(body["response"], np.uint8))
            entry = registry.get(name)
            x8 = x[:max_batch]
            batch_ms = _median_ms(lambda: entry.fetch(entry.dispatch(x8)),
                                  repeats=5)
            out[name] = {"masks": np.stack(masks), "batches": batches,
                         "launches": launches,
                         "p50": float(np.percentile(lat, 50)),
                         "p99": float(np.percentile(lat, 99)),
                         "batch_ms": batch_ms}
            log(f"[phase 18] (e) {name}: {len(images)} requests, {batches} "
                f"device batches, p50 {out[name]['p50']:.2f} ms, p99 "
                f"{out[name]['p99']:.2f} ms; a batch of {max_batch} through "
                f"dispatch + fetch {batch_ms:.3f} ms; int8_conv launches "
                f"{launches}")
    finally:
        srv.stop()
    if out["float"]["launches"] != 0:
        raise AssertionError("(e) the float model launched int8 convs")
    if out["int8"]["launches"] != 18 * out["int8"]["batches"]:
        raise AssertionError(f"(e) {out['int8']['launches']} int8_conv "
                             f"launches for {out['int8']['batches']} batches "
                             "(want 18: 17 DoubleConv convs past the stem and "
                             "the 1x1 head)")

    # the plain int8 forward on the served scales, and the float
    # probabilities, one batch of 8 at a time
    xt = torch.from_numpy(x).to(DEVICE).float() / 255.0
    with torch.inference_mode():
        with plain_int8(), quant.quant_mode("int8", q_entry.quant_scales,
                                            model):
            p_q = torch.cat([torch.sigmoid(model(xt[i:i + max_batch]).logits)
                             for i in range(0, len(x), max_batch)])
        # the served int8 program once more, for the shapes (a) checks
        with quant.quant_mode("int8", q_entry.quant_scales, model):
            hooks = _record_int8_shapes(model.module, shapes, "serve")
            model(xt[:max_batch])
            for h in hooks:
                h.remove()
    p_q = p_q[..., 0].cpu().numpy()
    p_f = np.concatenate([f_entry.probs_forward(x[i:i + max_batch]
                                                .astype(np.float32) / 255.0)
                          for i in range(0, len(x), max_batch)])[..., 0]
    plain_masks = (p_q > 0.5).astype(np.uint8)
    equal = float((out["int8"]["masks"] == plain_masks).mean())
    agree = float((out["int8"]["masks"] == out["float"]["masks"]).mean())
    thr = float(np.median(p_f))  # a split where the masks are not empty
    split = float(((p_q > thr) == (p_f > thr)).mean())
    log(f"[phase 18] (e) served int8 masks vs the plain int8 forward: "
        f"{equal:.6f} equal; vs the served float masks: {agree:.6f}; mask "
        f"foreground {out['int8']['masks'].mean():.4f} (int8), "
        f"{out['float']['masks'].mean():.4f} (float); int8 vs float "
        f"probabilities max |Δ| {float(np.abs(p_q - p_f).max()):.3e}, split "
        f"at the float median {thr:.5f}: {split:.5f} agree")
    if equal < INT8_SERVE_EQUAL or agree < INT8_SERVE_AGREE:
        raise AssertionError(f"(e) served int8 masks: {equal:.6f} equal to "
                             f"the plain int8 forward, {agree:.6f} agree "
                             "with float")
    del model
    torch.cuda.empty_cache()
    return {"float": {k: v for k, v in out["float"].items() if k != "masks"},
            "int8": {k: v for k, v in out["int8"].items() if k != "masks"},
            "equal": equal, "agree": agree, "median_split": split,
            "launches": out["int8"]["launches"]}


def _int8_case(shape_key, gen):
    """Seeded inputs of one recorded conv call: x, the quantized weight, a
    scale that clips the top 5%, the bias."""
    import torch

    from mdeical_image_segmentation_tpu_torch.ops import quant

    _, xs, xdt, ws, pads, odt, has_bias = shape_key
    x = torch.randn(xs, device=DEVICE, generator=gen).to(
        getattr(torch, xdt))
    w = torch.randn(ws, device=DEVICE, generator=gen) / math.sqrt(
        ws[1] * math.prod(ws[2:]))
    qw = quant.quantize_weight(w)
    x_scale = torch.clamp_min(x.float().abs().amax() * 0.95, 1e-12) / 127.0
    bias = (0.1 * torch.randn(ws[0], device=DEVICE, generator=gen)
            if has_bias else None)
    return x, qw, x_scale, bias, [tuple(p) for p in pads], getattr(torch, odt)


def _int8_kernel_checks(seed: int, shapes: set):
    """(a) both launches of ``int8_conv`` against their plain versions at
    every recorded shape, the ragged and the edge ones: ``int8_quantize``'s
    int8 values equal to ``_act_quant``'s, the int32 sums and the outputs
    equal to ``int8_conv_reference``'s, to the bit; times, the quantize
    pass counted in the conv's (and apart)."""
    import torch
    import torch.nn.functional as F

    from mdeical_image_segmentation_tpu_torch.ops import quant

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    sums = {}
    worst = 0.0
    log(f"{'config':9s} {'x (N, *spatial, Ci)':28s} {'in':5s} {'k':9s} "
        f"{'Co':>5s} {'window ms':>10s} {'device ms':>10s} {'quant ms':>9s} "
        f"{'quant dev':>10s} {'plain ms':>10s} {'cuDNN ms':>10s} "
        f"{'bound ms':>9s} {'share':>6s}")
    for key in sorted(shapes) + list(INT8_RAGGED) + list(INT8_EDGE):
        tag, xs, xdt, ws, pads, odt, _ = key
        x, qw, s, bias, pads, out_dtype = _int8_case(key, gen)
        kw = dict(pads=pads, bias=bias, out_dtype=out_dtype)
        n_check = xs[0] if x.numel() <= INT8_PLAIN_MAX_NUMEL else 1
        xc = x[:n_check].contiguous()
        x_q = quant.int8_quantize(xc, s)
        if not torch.equal(x_q, quant._act_quant(xc, s)):
            raise AssertionError(f"(a) {key}: int8_quantize differs from "
                                 "_act_quant")
        del x_q
        acc = quant.int8_conv(xc, qw, s, pads=pads, accumulators=True)
        y = quant.int8_conv(xc, qw, s, **kw)
        # the plain version once, timed: its sums, then its epilogue
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        acc_ref = quant.int8_conv_reference(xc, qw, s, pads=pads,
                                            accumulators=True)
        y_ref = quant.int8_rescale(acc_ref, s * qw.w_scale, bias, out_dtype)
        ev[1].record()
        ev[2].record()
        quant._act_quant(xc, s)
        ev[3].record()
        torch.cuda.synchronize()
        p_ms, qp_ms = ev[0].elapsed_time(ev[1]), ev[2].elapsed_time(ev[3])
        if not torch.equal(acc, acc_ref):
            raise AssertionError(f"(a) {key}: int32 sums differ, max "
                                 f"{(acc - acc_ref).abs().max().item()}")
        if not torch.equal(y, y_ref):
            err = (y.float() - y_ref.float()).abs().max().item()
            raise AssertionError(f"(a) {key}: outputs differ by {err:.3e}")
        del acc, acc_ref, y, y_ref
        nsp = len(ws) - 2
        conv = F.conv2d if nsp == 2 else F.conv3d
        wf = torch.randn(ws, device=DEVICE, generator=gen).to(x.dtype)
        xf = x.movedim(-1, 1)  # channels-last strided view, as TorchConv
        lo = tuple(p[0] for p in pads)

        def kernel():
            return quant.int8_conv(x, qw, s, **kw)

        def quantize():
            return quant.int8_quantize(x, s)

        def cudnn():
            return conv(xf, wf, padding=lo)

        k_ms, q_ms, c_ms = _time_turns(kernel, quantize, cudnn, budget_s=0.3)
        dev = _device_ms_by(kernel, INT8_KINDS, repeats=3, tries=8)
        d_ms = sum(dev.values())
        qd_ms = dev[INT8_KINDS[0]]
        out_pos = xs[0] * math.prod(
            n + 2 * p[0] - k + 1 for n, p, k in zip(xs[1:-1], pads, ws[2:]))
        taps_ci = ws[1] * math.prod(ws[2:])
        ops = 2.0 * out_pos * ws[0] * taps_ci
        nbytes = (x.numel() * x.element_size() + qw.w_q.numel()
                  + out_pos * ws[0] * torch.empty((), dtype=out_dtype)
                  .element_size())
        bound, by = _bound_ms(ops, nbytes, PEAK_INT8)
        # the quantize pass: x read, x_q written, a division an element
        q_bound = _bound_ms(x.numel(), x.numel() * (x.element_size() + 1),
                            PEAK_FP32)[0]
        log(f"{tag:9s} {str(xs):28s} {xdt[:5]:5s} {str(tuple(ws[2:])):9s} "
            f"{ws[0]:5d} {k_ms:10.3f} {_ms(d_ms):>10s} {q_ms:9.3f} "
            f"{_ms(qd_ms):>10s} {p_ms:10.3f} {c_ms:10.3f} {bound:9.4f} "
            f"{_share(bound, k_ms):>6s}"
            + (f"  (plain at N={n_check})" if n_check != xs[0] else ""))
        t = sums.setdefault(tag, {"n": 0, "window": 0.0, "device": 0.0,
                                  "plain": 0.0, "cudnn": 0.0, "bound": 0.0,
                                  "op": 0.0, "byte": 0.0, "plain_at_n1": 0,
                                  "n_dev": 0, "bound_dev": 0.0,
                                  "quant_window": 0.0, "quant_device": 0.0,
                                  "quant_plain": 0.0, "quant_bound": 0.0})
        t["n"] += 1
        t["plain_at_n1"] += n_check != xs[0]
        for k, v in (("window", k_ms), ("plain", p_ms),
                     ("cudnn", c_ms), ("bound", bound),
                     ("op", ops / PEAK_INT8 * 1e3),
                     ("byte", nbytes / HBM_BYTES_PER_S * 1e3),
                     ("quant_window", q_ms), ("quant_plain", qp_ms),
                     ("quant_bound", q_bound)):
            t[k] += v
        if not math.isnan(d_ms):  # the tracer kept both kernels' events
            t["n_dev"] += 1
            t["device"] += d_ms
            t["quant_device"] += qd_ms
            t["bound_dev"] += bound
        del x, xc, wf, xf
        torch.cuda.empty_cache()
    for tag, t in sums.items():
        if t["n_dev"] < t["n"]:  # a sum over fewer shapes is no total
            t["device"] = t["quant_device"] = math.nan
        log(f"[phase 18] (a) int8_conv over the {t['n']} {tag} shapes: "
            f"event window {t['window']:.4f} ms, device {_ms(t['device'])}"
            f" (traced at {t['n_dev']}; there {t['bound_dev']:.4f} ms of "
            f"bound), plain {t['plain']:.4f} ms ({t['plain_at_n1']} at N=1), "
            f"cuDNN float conv {t['cudnn']:.4f} ms; bound {t['bound']:.4f} "
            f"ms (share: window {_share(t['bound'], t['window'])}, device "
            f"{_share(t['bound'], t['device'])}); of it int8_quantize: "
            f"window {t['quant_window']:.4f} ms, device "
            f"{_ms(t['quant_device'])}, plain {t['quant_plain']:.4f} ms, "
            f"bound {t['quant_bound']:.4f} ms; every int8 value, int32 sum "
            "and output equal to the plain version's")
    return sums, worst


def phase_int8(seed: int, workdir: str):
    """Phase 18: the int8 path on the card; returns the kernels-line
    numbers of ``int8_conv``."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    shapes: set = set()
    t0 = time.time()
    bench = _int8_bench_row(seed, shapes)
    log(f"[phase 18] (b) wall {time.time() - t0:.1f} s")
    t0 = time.time()
    predict = _int8_predict_cli(seed, workdir, shapes)
    log(f"[phase 18] (c) wall {time.time() - t0:.1f} s")
    t0 = time.time()
    fidelity = _int8_fidelity(workdir, shapes)
    log(f"[phase 18] (d) wall {time.time() - t0:.1f} s")
    t0 = time.time()
    serving = _int8_serving(seed, workdir, shapes)
    log(f"[phase 18] (e) wall {time.time() - t0:.1f} s")
    t0 = time.time()
    sums, worst = _int8_kernel_checks(seed, shapes)
    log(f"[phase 18] (a) {len(shapes)} model shapes, {len(INT8_RAGGED)} "
        f"ragged and {len(INT8_EDGE)} edge ones; wall "
        f"{time.time() - t0:.1f} s")
    b = sums["bench"]
    return {
        "launches": (bench["launches"] + predict["launches"]
                     + fidelity["launches"] + serving["launches"]),
        "launches_by_path": {"bench_int8_forward": bench["launches"],
                             "predict3d_int8": predict["launches"],
                             "fidelity_predictor": fidelity["launches"],
                             "serve_2d_int8": serving["launches"]},
        "max_abs_err": worst,
        "ms": b["window"], "plain_ms": b["plain"], "bound_ms": b["bound"],
        "bound_by": "operations" if b["op"] >= b["byte"] else "bytes",
        "device_ms": None if math.isnan(b["device"]) else b["device"],
        "cudnn_float_conv_ms": b["cudnn"],
        # the quantize pass alone (its time is inside the numbers above);
        # one launch per int8_conv call, asserted on every path
        "quantize": {
            "ms": b["quant_window"], "plain_ms": b["quant_plain"],
            "bound_ms": b["quant_bound"],
            "device_ms": (None if math.isnan(b["quant_device"])
                          else b["quant_device"])},
        # the 3D kernels' launches on the int8 paths (3a, 3b, 4)
        "counts": {"bench_int8_forward": bench.pop("counts"),
                   "predict3d_int8": predict.pop("counts")},
        "bench": bench, "predict": predict,
        "fidelity": fidelity,
        "serving": {k: serving[k] for k in ("equal", "agree",
                                            "median_split")}
        | {f"{m}_{k}": serving[m][k] for m in ("float", "int8")
           for k in ("p50", "p99", "batch_ms")},
        "sums": sums,
    }


# ---------------------------------------------------------------------------
# 19. exported artifacts on the card; 20. SAM-Med2D promptable serving
# ---------------------------------------------------------------------------

EXPORT_BATCHES = (1, 2, 4, 8)   # the device batches the engine forms
SAM_CPU_TOL = 1e-4    # card vs CPU (fp32, TF32 off), x max(1, max |CPU|)
SAM_REQUESTS = 4      # per client


def _post_all(port: int, payloads, clients: int):
    """POST ``payloads`` from ``clients`` threads (client k sends k,
    k + clients, ...); returns (replies, wall s)."""
    replies = [None] * len(payloads)

    def client(k):
        for i in range(k, len(payloads), clients):
            replies[i] = _post(port, payloads[i])

    t0 = time.time()
    threads = [threading.Thread(target=client, args=(k,))
               for k in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads):
        raise AssertionError("a client did not finish within 600 s")
    for i, (status, body) in enumerate(replies):
        if status != 200 or body.get("status") != 200:
            raise AssertionError(f"request {i}: {status} {body}")
    return replies, time.time() - t0


def _latency_pcts(replies):
    """(p50, p99) of the replies' server-side latency_ms."""
    import numpy as np

    lat = [body["latency_ms"] for _, body in replies]
    return float(np.percentile(lat, 50)), float(np.percentile(lat, 99))


def _reply_mask(body, res: int):
    import numpy as np

    mask = np.asarray(body["response"], np.uint8)
    if mask.shape != (res, res) or mask.max() > 1:
        raise AssertionError(f"bad mask {mask.shape}")
    return mask


def _export_2d(seed: int, workdir: str):
    """(a) Phase 2's bundle exported with a symbolic batch on the card,
    saved, loaded; the artifact against the live register_unet2d forward
    at batches 1, 2, 4, 8, then served beside it over HTTP."""
    import numpy as np

    from mdeical_image_segmentation_tpu_torch.data.png2d import nearest_resize
    from mdeical_image_segmentation_tpu_torch.export import (
        export_bundle,
        load_exported,
    )
    from mdeical_image_segmentation_tpu_torch.ops.fused_conv import (
        fused_double2d,
    )
    from mdeical_image_segmentation_tpu_torch.serve import (
        ModelRegistry,
        SegmentationServer,
    )
    from mdeical_image_segmentation_tpu_torch.utils import png

    res, max_batch, clients = 256, 8, 8
    bundle = unet2d_bundle(seed, workdir)
    t0 = time.time()
    art = export_bundle(bundle, os.path.join(workdir, "unet2d_pt2"),
                        resolution=(res, res), device="cuda")
    export_s = time.time() - t0
    t0 = time.time()
    loaded = load_exported(art, device="cuda")
    load_s = time.time() - t0
    meta = loaded.meta
    graph_ops = sorted({str(n.target) for n in loaded.program.graph.nodes
                        if str(n.target).startswith("tpuseg.")})
    log(f"[phase 19] exported {meta['unet_type']} {meta['input_shape']} in "
        f"{export_s:.2f} s, loaded in {load_s:.2f} s; model.pt2 "
        f"{meta['artifact_bytes']} bytes; custom ops in the graph "
        f"{graph_ops}")
    if graph_ops != ["tpuseg.fused_double2d_y.default"]:
        raise AssertionError(f"the exported graph calls {graph_ops}, want "
                             "kernel 1's op")

    registry = ModelRegistry()
    registry.register_unet2d("unet", bundle, resolution=res, device="cuda",
                             max_batch=max_batch)
    live = registry.get("unet")
    images, _ = scan_pngs(seed, workdir)
    x8 = np.stack([nearest_resize(png.read(p, "L")[..., None], (res, res))
                   for p in images[:max_batch]])
    launches = {}
    for b in EXPORT_BATCHES:
        xf = x8[:b].astype(np.float32) / 255.0
        fused_double2d.launches = 0
        got = loaded(xf)
        launches[b] = fused_double2d.launches
        want = live.probs_forward(xf)
        err = float(np.abs(got - want).max())
        log(f"  batch {b}: artifact vs live register_unet2d forward: same "
            f"bits {np.array_equal(got, want)} (max |diff| {err:.3e}); "
            f"{launches[b]} kernel-1 launches; p in [{got.min():.4f}, "
            f"{got.max():.4f}]")
        if not np.array_equal(got, want):
            raise AssertionError(f"batch {b}: the artifact's probabilities "
                                 "differ from the live forward's")
        if launches[b] != 18:
            raise AssertionError(f"batch {b}: {launches[b]} kernel-1 "
                                 "launches, want 18")

    registry.register_exported("aot", art, device="cuda",
                               max_batch=max_batch)
    srv = SegmentationServer(registry,
                             output_dir=os.path.join(workdir, "masks19"),
                             max_batch=max_batch, max_wait_ms=5.0)
    port = srv.start(host="127.0.0.1", port=0).server_address[1]
    n_req = clients * 4
    try:
        occ0 = srv.engine.occupancy().get("aot", {"batches": 0})["batches"]
        fused_double2d.launches = 0
        aot, aot_wall = _post_all(port, [
            {"image_path": images[i % len(images)], "model": "aot",
             "return": "mask"} for i in range(n_req)], clients)
        served_launches = fused_double2d.launches
        batches = srv.engine.occupancy()["aot"]["batches"] - occ0
        ref, ref_wall = _post_all(port, [
            {"image_path": images[i % len(images)], "model": "unet",
             "return": "mask"} for i in range(n_req)], clients)
    finally:
        srv.stop()
    if batches <= 0 or served_launches != 18 * batches:
        raise AssertionError(f"{served_launches} kernel-1 launches for "
                             f"{batches} served artifact batches (want 18 "
                             "per batch)")
    for i, ((_, a), (_, r)) in enumerate(zip(aot, ref)):
        if not np.array_equal(_reply_mask(a, res), _reply_mask(r, res)):
            raise AssertionError(f"request {i}: the artifact's mask differs "
                                 "from register_unet2d's")
    aot_ms = _median_ms(lambda: loaded.fetch(loaded.dispatch(
        x8.astype(np.float32) / 255.0)), repeats=5)
    aot_batch_ms = _median_ms(lambda: registry.get("aot").fetch(
        registry.get("aot").dispatch(x8)), repeats=5)
    live_batch_ms = _median_ms(lambda: live.fetch(live.dispatch(x8)),
                               repeats=5)
    out = {
        "export_s": export_s, "load_s": load_s,
        "artifact_bytes": meta["artifact_bytes"],
        "launches_per_batch": launches, "served_batches": batches,
        "served_launches": served_launches,
        "p50_p99_ms": _latency_pcts(aot),
        "unet2d_p50_p99_ms": _latency_pcts(ref),
        "wall_s": aot_wall, "unet2d_wall_s": ref_wall,
        "batch8_ms": aot_batch_ms, "unet2d_batch8_ms": live_batch_ms,
        "artifact_probs_batch8_ms": aot_ms,
    }
    log(f"[phase 19] {n_req} requests from {clients} clients through "
        f"register_exported in {aot_wall:.3f} s ({batches} batches, "
        f"{served_launches} kernel-1 launches), masks equal to "
        f"register_unet2d's for the same PNGs; p50 / p99 "
        f"{out['p50_p99_ms'][0]:.2f} / {out['p50_p99_ms'][1]:.2f} ms "
        f"(register_unet2d {out['unet2d_p50_p99_ms'][0]:.2f} / "
        f"{out['unet2d_p50_p99_ms'][1]:.2f}); a served batch of 8 "
        f"{aot_batch_ms:.3f} ms (register_unet2d {live_batch_ms:.3f} ms; "
        f"the artifact alone, probabilities out, {aot_ms:.3f} ms)")
    return out


def _export_3d(seed: int, workdir: str):
    """(b) Phase 3's UNet3D and phase 4's ResidualUNet3D exported at their
    padded predictor patch; one batch of the predictor's size through the
    artifact against the eager forward, launches counted."""
    import numpy as np
    import torch

    from mdeical_image_segmentation_tpu_torch.export import (
        export_bundle,
        load_exported,
    )
    from mdeical_image_segmentation_tpu_torch.models import (
        UNet3DConfig,
        UNet3DForMedicalSegmentation,
    )

    torch.backends.cudnn.allow_tf32 = False
    cfg = read_yaml_subset(PREDICT_YML)
    batch = cfg["loaders"]["batch_size"]
    blocks = 2 * RESIDUAL_MODEL["num_levels"] - 1
    out = {}
    for k, (name, model_cfg, slices, tol, want) in enumerate((
            ("UNet3D", cfg["model"], cfg["loaders"]["test"]["slice_builder"],
             UNET3D_MAP_TOL, {"gcr_conv3d": 14, "gn_stats": 14,
                              "gn_affine": 0}),
            ("ResidualUNet3D", RESIDUAL_MODEL, RESIDUAL_SLICES,
             RESIDUAL_MAP_TOL, {"gcr_conv3d": blocks,
                                "gn_stats": 2 * blocks,
                                "gn_affine": blocks}))):
        patch = [p + 2 * h for p, h in zip(slices["patch_shape"],
                                           slices["halo_shape"])]
        config = UNet3DConfig.from_dict({**model_cfg,
                                         "unet_type": model_cfg["name"]})
        bundle = os.path.join(workdir, f"{name}_bundle")
        UNet3DForMedicalSegmentation(
            config, device="cpu",
            generator=torch.Generator().manual_seed(seed + k)
        ).save_pretrained(bundle)
        t0 = time.time()
        art = export_bundle(bundle, os.path.join(workdir, f"{name}_pt2"),
                            patch_shape=patch, device="cuda")
        export_s = time.time() - t0
        loaded = load_exported(art, device="cuda")
        x = np.stack([seeded_volume(patch, seed + k + i)[..., None]
                      for i in range(batch)])
        _zero_counts()
        got = loaded.dispatch(x)
        torch.cuda.synchronize()
        n = _counts()
        eager = UNet3DForMedicalSegmentation.from_pretrained(bundle,
                                                             device="cuda")
        with torch.inference_mode():
            ref = eager(torch.from_numpy(x).cuda()).logits
        err = float((got - ref).abs().max())
        scale = max(1.0, float(ref.abs().max()))
        same = bool(torch.equal(got, ref))
        log(f"  {name} {loaded.meta['input_shape']}: exported in "
            f"{export_s:.2f} s, {loaded.meta['artifact_bytes']} bytes; batch "
            f"{batch}: artifact vs eager same bits {same}, max |diff| "
            f"{err:.3e} (limit {tol} x {scale:.3f}); launches {n}")
        if err > tol * scale or not torch.isfinite(got).all():
            raise AssertionError(f"{name}: the artifact's output differs from "
                                 f"the eager forward by {err:.3e}")
        if any(n[kk] != v for kk, v in want.items()):
            raise AssertionError(f"{name}: launches {n} per batch, want {want}")
        out[name] = {"export_s": export_s, "err": err, "same_bits": same,
                     "launches": n,
                     "artifact_bytes": loaded.meta["artifact_bytes"]}
        del loaded, eager, got, ref
        torch.cuda.empty_cache()
    return out


def phase_export(seed: int, workdir: str):
    """19. The export path on the card (``export.py``, kernels 1, 2, 3a
    and 3b as ``tpuseg::`` custom ops)."""
    out = {"2d": _export_2d(seed, workdir)}
    out["3d"] = _export_3d(seed, workdir)
    return out


def _sam_payloads(seed: int, images, arrays, n: int):
    """``n`` promptable requests over the scans: point prompts (1-8 points,
    some background), box prompts, and points with a box, in turn, in each
    image's own pixels."""
    import numpy as np

    rng = np.random.default_rng(seed)
    payloads = []
    for i in range(n):
        j = i % len(images)
        h, w = arrays[j].shape[:2]
        p = {"image_path": images[j], "model": "sam", "return": "mask"}
        if i % 3 != 1:
            k = int(rng.integers(1, 9))
            p["points"] = [[float(rng.uniform(0, w)), float(rng.uniform(0, h))]
                           for _ in range(k)]
            p["point_labels"] = [1] + [int(v) for v in
                                       rng.integers(0, 2, k - 1)]
        if i % 3 != 0:
            x0, y0 = rng.uniform(0, w / 2), rng.uniform(0, h / 2)
            p["box"] = [[float(x0), float(y0)],
                        [float(rng.uniform(x0 + 8, w)),
                         float(rng.uniform(y0 + 8, h))]]
        payloads.append(p)
    return payloads


def phase_sam(seed: int, workdir: str):
    """20. SAM-Med2D at the JAX package's defaults, served on the card."""
    import numpy as np
    import torch

    from mdeical_image_segmentation_tpu_torch.models.sam import (
        SAMMed2D,
        load_sam,
        save_sam,
    )
    from mdeical_image_segmentation_tpu_torch.ops.image import (
        resize_bilinear,
    )
    from mdeical_image_segmentation_tpu_torch.serve import (
        ModelRegistry,
        SegmentationServer,
    )

    max_batch, clients = 8, 8
    model = SAMMed2D(device="cpu",
                     generator=torch.Generator().manual_seed(seed))
    n_params = sum(p.numel() for p in model.parameters())
    bundle = os.path.join(workdir, "sam_med2d")
    save_sam(bundle, model)
    log(f"[phase 20] SAMMed2D {model.config()}: {n_params} parameters "
        f"({4 * n_params / 1e6:.1f} MB fp32)")
    t0 = time.time()
    registry = ModelRegistry()
    registry.register_sam("sam", bundle, device="cuda", max_batch=max_batch)
    register_s = time.time() - t0
    entry = registry.get("sam")
    res = entry.resolution
    recorded = []
    dispatch = entry.dispatch

    def recording(*xs):
        handle = dispatch(*xs)
        recorded.append((xs, handle))
        return handle

    entry.dispatch = recording
    images, arrays = scan_pngs(seed, workdir)
    payloads = _sam_payloads(seed, images, arrays, clients * SAM_REQUESTS)
    srv = SegmentationServer(registry,
                             output_dir=os.path.join(workdir, "masks20"),
                             max_batch=max_batch, max_wait_ms=5.0)
    port = srv.start(host="127.0.0.1", port=0).server_address[1]
    try:
        replies, wall = _post_all(port, payloads, clients)
        for bad, want in ((
                {"image_path": images[0], "model": "sam"},
                "needs points and/or box"),
                ({"image_path": images[0], "model": "sam",
                  "points": [[1, 1]] * 9}, "too many points")):
            status, body = _post(port, bad)
            if status != 400 or want not in body["response"]:
                raise AssertionError(f"{bad}: {status} {body}")
    finally:
        srv.stop()
    entry.dispatch = dispatch
    masks = [_reply_mask(body, res) for _, body in replies]

    eager = load_sam(bundle, device="cuda")

    def eager_masks(img_u8, pts, lbl, box=None):
        dev = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
               for a in (img_u8, pts, lbl) + (() if box is None else (box,))]
        with torch.inference_mode():
            low, _ = eager(dev[0].float() / 255.0, *dev[1:])
            up = resize_bilinear(low.permute(0, 2, 3, 1), (res, res))
            return (torch.sigmoid(up[..., 0]) > 0.5).to(torch.uint8
                                                        ).cpu().numpy()

    sizes = []
    for xs, handle in recorded:
        sizes.append(len(xs[0]))
        if not np.array_equal(entry.fetch(handle), eager_masks(*xs)):
            raise AssertionError(f"a served batch of {len(xs[0])} "
                                 f"({len(xs)} inputs) differs from the eager "
                                 "forward at the same batch")
    agree = []
    for p, m in zip(payloads, masks):
        img, orig_hw = srv._build_input(p["image_path"], entry)
        pts, lbl, box = srv._build_prompts(p, entry, orig_hw)
        one = eager_masks(img[None], pts[None], lbl[None],
                          None if box is None else box[None])[0]
        agree.append(float(np.mean(one == m)))
    log(f"[phase 20] {len(payloads)} requests from {clients} clients in "
        f"{wall:.3f} s, {len(recorded)} device batches of sizes "
        f"{sorted(sizes)}; every served batch equals the eager forward at "
        f"the same batch; per request vs its own batch-1 forward: agreement "
        f"min {min(agree):.6f}; mask fg shares "
        f"{[round(float(m.mean()), 3) for m in masks[:6]]}...")
    if min(agree) < MASK_AGREEMENT:
        raise AssertionError("a served mask disagrees with its batch-1 "
                             "forward")

    # card vs CPU on the same weights, fp32 with TF32 off
    xs = max((x for x, _ in recorded if len(x) == 4),
             key=lambda x: len(x[0]))
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = load_sam(bundle, device="cpu")
    errs = {}
    try:
        for multi in (False, True):
            args = [torch.from_numpy(np.ascontiguousarray(a)) for a in xs]
            args[0] = args[0].float() / 255.0
            with torch.inference_mode():
                c_low, c_iou = cpu(*args, multimask_output=multi)
                g_low, g_iou = eager(*(a.cuda() for a in args),
                                     multimask_output=multi)
            for tag, g, c in (("logits", g_low, c_low), ("iou", g_iou, c_iou)):
                e = float((g.cpu() - c).abs().max())
                scale = max(1.0, float(c.abs().max()))
                errs[f"{tag}{'_multi' if multi else ''}"] = e
                if e > SAM_CPU_TOL * scale:
                    raise AssertionError(f"SAM {tag} (multimask {multi}): "
                                         f"card vs CPU {e:.3e} > "
                                         f"{SAM_CPU_TOL} x {scale:.3f}")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    log(f"  card vs CPU, batch {len(xs[0])} with a box, fp32 TF32 off: max "
        f"|diff| {errs} (limit {SAM_CPU_TOL} x max(1, max |CPU|))")

    enc_ms = {}
    for b in (1, 8):
        x = torch.rand((b, res, res, 1), device="cuda",
                       generator=torch.Generator("cuda").manual_seed(seed))
        with torch.inference_mode():
            enc_ms[b] = _best_ms(lambda: eager.image_encoder(x))
    batch8 = next((x for x, _ in recorded if len(x[0]) == 8), None)
    if batch8 is None:
        batch8 = tuple(np.concatenate([a] * (8 // len(a)))
                       for a in recorded[0][0])
    batch_ms = _median_ms(lambda: entry.fetch(entry.dispatch(*batch8)),
                          repeats=5)
    p50, p99 = _latency_pcts(replies)
    log(f"[phase 20] registered in {register_s:.2f} s; encoder forward "
        f"(best of {INT8_BLOCKS} blocks of {INT8_BLOCK_FORWARDS}, CUDA events)"
        f" {enc_ms[1]:.3f} ms at batch 1, {enc_ms[8]:.3f} ms at batch 8; a "
        f"served batch of 8 ({len(batch8)} inputs) {batch_ms:.3f} ms; p50 / "
        f"p99 {p50:.2f} / {p99:.2f} ms")
    return {"params": n_params, "register_s": register_s,
            "encoder_ms": enc_ms, "batch8_ms": batch_ms,
            "p50_p99_ms": (p50, p99), "wall_s": wall,
            "batches": sorted(sizes), "cpu_errs": errs,
            "min_agreement": min(agree)}


# ---------------------------------------------------------------------------
# Phase 21: the rest of the config-driven 3D pipeline: LazyPredictor over
# LazyHDF5Dataset, DSB2018 2D prediction, the optimizers written after
# optax's rules and the instance and surface metrics
# ---------------------------------------------------------------------------

# the Lazy map against phase 14's Standard map, x max(1, |map|): both sum
# the same fp32 patches (patch = stride: one patch a voxel), only the
# order of the sums and the host division differ
LAZY_MAP_TOL = 1e-5
DSB_IMAGES = 16
DSB_SIZE = (256, 256)
# phase 17's UNet2D; 'gcr' in 2D runs the GroupNorm module (kernels 3a and
# 3b) and a cuDNN conv, not the fused kernel 2
DSB_MODEL = {"name": "UNet2D", "in_channels": 1, "out_channels": 1,
             "f_maps": 64, "num_levels": 4, "layer_order": "gcr",
             "final_sigmoid": True}
DSB_BATCH = 4
OPT_STEPS = 3
OPT_TOL = 1e-6  # card vs CPU parameters after OPT_STEPS, x each tensor's max
NEW_OPTIMIZERS = {"Adadelta": {}, "Adagrad": {}, "SparseAdam": {},
                  "Adamax": {}, "ASGD": {}, "NAdam": {}, "RAdam": {},
                  "RMSprop": {}, "Rprop": {"momentum": 0.9}}


def _lazy_predict(seed: int, workdir: str, checkpoint: str, standard: dict):
    """cli/predict3d.py on configs/unet3d_predict.yml with LazyHDF5Dataset
    and LazyPredictor on phase 14's volume and checkpoint: the first run
    appends the padded memo to the volume, the second reads it, the third
    saves the segmentation alone."""
    import numpy as np
    import torch

    from mdeical_image_segmentation_tpu_torch.cli import predict3d
    from mdeical_image_segmentation_tpu_torch.infer import (
        predictor as predictor_lib,
    )
    from mdeical_image_segmentation_tpu_torch.metrics import dc, hd95
    from mdeical_image_segmentation_tpu_torch.utils import hdf5

    cfg = read_yaml_subset(PREDICT_YML)
    halo = cfg["loaders"]["test"]["slice_builder"]["halo_shape"]
    memo = "raw_padded_" + "x".join(str(h) for h in halo)
    with hdf5.File(standard["file"]) as f:
        want = f["predictions"][:]
    scale = max(1.0, float(np.abs(want).max()))
    out, total = {}, {k: 0 for k in KERNELS_3D}
    get, save = (predictor_lib.get_predictor,
                 predictor_lib.LazyPredictor._save_results)
    for run, seg in (("memo written", False), ("memo read", False),
                     ("segmentation", True)):
        out_dir = os.path.join(workdir, f"lazy_{len(out)}")
        argv = ["--config", PREDICT_YML, "--model_path", checkpoint,
                "--output_dir", out_dir,
                "--loaders.test.file_paths", repr([standard["volume"]]),
                "--loaders.dataset", "LazyHDF5Dataset",
                "--predictor.name", "LazyPredictor",
                "--predictor.save_segmentation", str(seg).lower()]
        rec, save_s = [], []

        def instrumented(model, output_dir, config, **kw):
            p = get(model, output_dir, config, **kw)
            _timed_batches(p, rec)
            return p

        def timed_save(self, *args):
            t0 = time.perf_counter()
            save(self, *args)
            save_s.append(time.perf_counter() - t0)

        predictor_lib.get_predictor = instrumented
        predictor_lib.LazyPredictor._save_results = timed_save
        try:
            with _io_timer() as io:
                torch.cuda.synchronize()
                _zero_counts()
                t0 = time.perf_counter()
                (written,) = predict3d.main(argv)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = _counts()
        finally:
            predictor_lib.get_predictor = get
            predictor_lib.LazyPredictor._save_results = save
        for i, (ms, n) in enumerate(rec):
            if n["gcr_conv3d"] != 14 or n["gn_stats"] != 14:
                raise AssertionError(f"lazy {run}, batch {i}: {n}, want 14 "
                                     "gcr_conv3d and 14 gn_stats launches")
        if len(rec) != 2 or launches["overlap_add"] != 0:
            raise AssertionError(f"lazy {run}: {launches} over {len(rec)} "
                                 "batches: want 2 batches, no overlap_add "
                                 "(the patches are summed on the host)")
        for k in KERNELS_3D:
            total[k] += launches[k]
        with hdf5.File(standard["volume"]) as f:
            if memo not in f:
                raise AssertionError(f"lazy {run}: {standard['volume']} "
                                     f"holds no {memo}")
        with hdf5.File(written) as f:
            keys = sorted(f.keys())
            got = f[keys[0]][:]
        entry = {"wall_s": wall, "save_s": save_s[0],
                 "write_s": io.write_s, "read_s": io.read_s,
                 "write_mib": io.write_bytes / 2**20,
                 "read_mib": io.read_bytes / 2**20, "launches": launches,
                 "batch_ms": [ms for ms, _ in rec]}
        if seg:
            ref = np.argmax(out["memo read"]["map"], axis=0).astype(np.uint16)
            if keys != ["segmentation"] or not np.array_equal(got, ref):
                raise AssertionError(f"lazy segmentation: the file holds "
                                     f"{keys}, want ['segmentation'] equal "
                                     "to the argmax of the map")
        else:
            if keys != ["predictions"] or got.shape != want.shape:
                raise AssertionError(f"lazy {run}: {keys} {got.shape}, want "
                                     f"['predictions'] {want.shape}")
            err = float(np.abs(got - want).max())
            if not np.isfinite(got).all() or err > LAZY_MAP_TOL * scale:
                raise AssertionError(f"lazy {run}: the map differs from "
                                     f"phase 14's by {err:.3e} (limit "
                                     f"{LAZY_MAP_TOL} x {scale:.3f})")
            entry.update(err=err, map=got)
        out[run] = entry
        log(f"[phase 21] (a) lazy predict3d, {run}: {wall:.2f} s (phase 14's"
            f" StandardPredictor {standard['wall_s']:.2f} s); batches "
            + ", ".join(f"{ms:.1f}" for ms in entry["batch_ms"])
            + f" ms; the slice normalization and the streamed write "
            f"{save_s[0]:.2f} s; HDF5 writes {io.write_s:.2f} s "
            f"({io.write_bytes / 2**20:.1f} MiB"
            + (", the memo's included" if run == "memo written" else "")
            + f"), reads {io.read_s:.2f} s ({io.read_bytes / 2**20:.1f} MiB); "
            f"{written} holds {keys}"
            + (f"; map vs phase 14 max |diff| {entry['err']:.3e}"
               if "err" in entry else "; segmentation = argmax of the map")
            + f"; launches {launches}")
    # the thresholded map against the volume's labels: phase 13's rule
    # (the smoothed raw above its 25th percentile); the 11-step weights are
    # near chance, so the map is cut at its median
    raw = seeded_volume(VOLUME_3D, seed)
    label = foreground_label(raw).astype(bool)
    m = out["memo read"]["map"][0]
    mask = m > np.median(m)
    t0 = time.perf_counter()
    hd = hd95(mask, label)
    hd_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    dice = dc(mask, label)
    dc_ms = (time.perf_counter() - t0) * 1e3
    log(f"[phase 21] (a) the memo-read map cut at its median against the "
        f"volume's labels: hd95 {hd:.3f} voxels ({hd_ms:.0f} ms on the "
        f"host), dc {dice:.4f} ({dc_ms:.0f} ms)")
    for entry in out.values():
        entry.pop("map", None)
    return {"runs": out, "launches": total, "hd95": hd, "hd95_ms": hd_ms,
            "dc": dice, "dc_ms": dc_ms,
            "standard_wall_s": standard["wall_s"]}


def _dsb_predict(seed: int, workdir: str):
    """16 seeded 8-bit grey PNGs at 256² in DSB's images/ layout through
    cli/predict3d.py with DSB2018Dataset and DSB2018Predictor and phase
    17's UNet2D; each image's file against the plain path."""
    import numpy as np
    import torch
    from scipy import ndimage

    from mdeical_image_segmentation_tpu_torch.cli import predict3d
    from mdeical_image_segmentation_tpu_torch.data.loaders import (
        get_test_loaders,
    )
    from mdeical_image_segmentation_tpu_torch.infer import (
        predictor as predictor_lib,
    )
    from mdeical_image_segmentation_tpu_torch.transforms.skimage_compat import (
        label as cc_label,
    )
    from mdeical_image_segmentation_tpu_torch.utils import hdf5, png, yaml_io

    root = os.path.join(workdir, "dsb")
    os.makedirs(os.path.join(root, "images"))
    rng = np.random.default_rng(seed + 21)
    for i in range(DSB_IMAGES):
        v = ndimage.gaussian_filter(rng.random(DSB_SIZE), 4.0)
        v = (v - v.min()) / (v.max() - v.min()) * 255
        png.write(os.path.join(root, "images", f"scan{i:02d}.png"),
                  v.astype(np.uint8))
    ckpt = _initial_checkpoint(DSB_MODEL, seed, workdir, "dsb_unet2d")
    pred_cfg = read_yaml_subset(PREDICT_YML)
    cfg = {"model": DSB_MODEL, "model_path": ckpt,
           "output_dir": os.path.join(workdir, "dsb_out"),
           "predictor": {"name": "DSB2018Predictor"},
           "loaders": {"dataset": "DSB2018Dataset", "batch_size": DSB_BATCH,
                       "test": {"file_paths": [root], "transformer":
                                pred_cfg["loaders"]["test"]["transformer"]}}}
    os.makedirs(cfg["output_dir"])  # the predictor writes into it
    cfg_path = os.path.join(workdir, "dsb_predict.yml")
    with open(cfg_path, "w") as f:
        f.write(yaml_io.dumps(cfg))
    made, walls = [], []
    get, call = (predictor_lib.get_predictor,
                 predictor_lib.DSB2018Predictor.__call__)

    def instrumented(model, output_dir, config, **kw):
        p = get(model, output_dir, config, **kw)
        made.append(p)
        return p

    def timed_call(self, loader):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        files = call(self, loader)
        walls.append(time.perf_counter() - t0)
        return files

    predictor_lib.get_predictor = instrumented
    predictor_lib.DSB2018Predictor.__call__ = timed_call
    try:
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        (files,) = predict3d.main(["--config", cfg_path])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts()
    finally:
        predictor_lib.get_predictor = get
        predictor_lib.DSB2018Predictor.__call__ = call
    levels = DSB_MODEL["num_levels"]
    per_batch = 2 * (2 * levels - 1)  # GroupNorm modules of a forward
    batches = -(-DSB_IMAGES // DSB_BATCH)
    want = {"gcr_conv3d": 0, "gn_stats": per_batch * batches,
            "gn_affine": per_batch * batches, "gn_bwd_reduce": 0,
            "gn_bwd_dx": 0, "overlap_add": 0}
    if launches != want or len(files) != DSB_IMAGES:
        raise AssertionError(f"dsb: {launches} for {len(files)} files, want "
                             f"{want} for {DSB_IMAGES}")
    with plain_path():
        plain = get(made[0].model, os.path.join(workdir, "dsb_plain"),
                    {"model": DSB_MODEL, "predictor": cfg["predictor"]})
        os.makedirs(plain.output_dir)
        (loader,) = get_test_loaders(cfg)
        plain_files = plain(loader)
    worst = 0.0
    for f_kernel, f_plain in zip(sorted(files), sorted(plain_files)):
        with hdf5.File(f_kernel) as f, hdf5.File(f_plain) as g:
            p, q = f["predictions"][:], g["predictions"][:]
            seg = f["segmentation"][:]
        err = float(np.abs(p - q).max())
        worst = max(worst, err)
        if p.shape != DSB_SIZE or err > UNET3D_MAP_TOL * max(
                1.0, float(np.abs(q).max())):
            raise AssertionError(f"dsb {f_kernel}: {p.shape}, kernel vs "
                                 f"plain {err:.3e}")
        if seg.dtype != np.uint16 or not np.array_equal(
                seg, cc_label(p > 0.5).astype(np.uint16)):
            raise AssertionError(f"dsb {f_kernel}: the segmentation is not "
                                 "label(p > 0.5) of its map")
    log(f"[phase 21] (b) DSB2018: {DSB_IMAGES} images of {DSB_SIZE} through "
        f"predict3d in {wall:.2f} s, the predictor's call {walls[0]:.2f} s "
        f"({DSB_IMAGES / walls[0]:.1f} images/s, forwards and the 8 "
        f"writer threads); kernel vs plain max |diff| {worst:.3e} (limit "
        f"{UNET3D_MAP_TOL}); segmentations = label(p > 0.5); launches "
        f"{launches}")
    return {"launches": launches, "wall_s": wall, "call_s": walls[0],
            "images_per_s": DSB_IMAGES / walls[0], "err": worst}


def _train_new_optimizers(seed: int, workdir: str, cfg_train: dict):
    """cli/train3d.py on configs/unet3d_train.yml and phase 13's volumes,
    3 steps and one validation with NAdam and BoundaryAdaptedRandError;
    then each of the nine steppable new optimizers, 3 updates of phase 9's
    UNet3D parameters on the card against the CPU; LBFGS raises."""
    import numpy as np
    import torch

    from mdeical_image_segmentation_tpu_torch.cli import train3d
    from mdeical_image_segmentation_tpu_torch.metrics import (
        get_evaluation_metric,
    )
    from mdeical_image_segmentation_tpu_torch.models import get_model
    from mdeical_image_segmentation_tpu_torch.train import trainer3d
    from mdeical_image_segmentation_tpu_torch.train.optimizers import (
        create_optimizer,
    )

    cfg = read_yaml_subset(TRAIN_YML)
    run_dir = os.path.join(workdir, "train_nadam")
    metric_cfg = {"name": "BoundaryAdaptedRandError"}
    argv = ["--config", TRAIN_YML,
            "--loaders.train.file_paths", repr([cfg_train["train_h5"]]),
            "--loaders.val.file_paths", repr([cfg_train["val_h5"]]),
            "--trainer.checkpoint_dir", run_dir,
            "--trainer.max_num_iterations", "2",
            "--trainer.validate_after_iters", "3",
            "--trainer.log_after_iters", "3",
            "--optimizer.name", "NAdam",
            "--eval_metric.name", metric_cfg["name"]]
    rec, scored, made = [], [], []
    create = trainer3d.create_trainer

    def instrumented(config):
        t = create(config)
        _instrument(t, rec)
        metric = t.eval_criterion

        def recording(output, target):
            score = metric(output, target)
            scored.append((output.detach().float().cpu().numpy(),
                           target.detach().cpu().numpy(), score))
            return score

        t.eval_criterion = recording
        made.append(t)
        return t

    trainer3d.create_trainer = instrumented
    threads = set(threading.enumerate())
    try:
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        trainer = train3d.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts()
    finally:
        trainer3d.create_trainer = create
    for t in set(threading.enumerate()) - threads:
        if t.name.endswith("(producer)"):
            t.join(timeout=120)
    trainer.loaders["train"].close()
    trainer.loaders["val"].close()
    if type(trainer.optimizer).__name__ != "NAdam":
        raise AssertionError(f"train3d built a {type(trainer.optimizer)}")
    convs = 2 * (2 * cfg["model"]["num_levels"] - 1)
    want = {"gcr_conv3d": convs, "gn_stats": convs, "gn_affine": convs,
            "gn_bwd_reduce": convs, "gn_bwd_dx": convs - 1, "overlap_add": 0}
    losses = [r["loss"] for r in rec]
    if (len(rec) != 3 or any(r["launches"] != want for r in rec)
            or not np.isfinite(losses).all()):
        raise AssertionError(f"train3d NAdam: {len(rec)} steps, losses "
                             f"{losses}, launches "
                             f"{[r['launches'] for r in rec]}, want 3 "
                             f"finite steps of {want}")
    cpu_metric = get_evaluation_metric({"eval_metric": metric_cfg})
    if not scored:
        raise AssertionError("train3d NAdam: no evaluation was scored")
    for output, target, score in scored:
        again = cpu_metric(output, target)
        if again != score:
            raise AssertionError(f"BoundaryAdaptedRandError on the card's "
                                 f"fetched output {score} != {again} on "
                                 "the CPU")
    log(f"[phase 21] (c) train3d with NAdam and BoundaryAdaptedRandError: "
        f"{len(rec)} steps in {wall:.2f} s, step ms "
        + ", ".join(f"{r['ms']:.1f}" for r in rec)
        + f", losses {', '.join(f'{x:.6f}' for x in losses)}; "
        f"{len(scored)} scores ({', '.join(f'{x[2]:.6f}' for x in scored)})"
        f" equal to the CPU metric on the fetched output; launches "
        f"{launches}")
    del trainer, made

    # phase 9's UNet3D parameters, seeded gradients
    model = get_model(cfg["model"],
                      generator=torch.Generator().manual_seed(seed))
    params = [p.detach().clone() for p in model.parameters()]
    del model
    gen = torch.Generator().manual_seed(seed + 21)
    grads = [[torch.randn(p.shape, generator=gen) * 1e-2 for p in params]
             for _ in range(OPT_STEPS)]
    base = {"learning_rate": cfg["optimizer"]["learning_rate"],
            "weight_decay": cfg["optimizer"]["weight_decay"]}
    results = {}
    for name, knobs in NEW_OPTIMIZERS.items():
        sides = {}
        for device in ("cpu", DEVICE):
            ps = [torch.nn.Parameter(p.to(device, copy=True)) for p in params]
            opt = create_optimizer({"name": name, **base, **knobs}, ps)
            ms = []
            for step in range(OPT_STEPS):
                for p, g in zip(ps, grads[step]):
                    p.grad = g.to(device)
                if device == DEVICE:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    opt.step()
                    end.record()
                    torch.cuda.synchronize()
                    ms.append(start.elapsed_time(end))
                else:
                    opt.step()
            sides[device] = ([p.detach().cpu() for p in ps], ms)
        worst = 0.0
        for got, ref, p0 in zip(sides[DEVICE][0], sides["cpu"][0], params):
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            worst = max(worst, err / max(scale, 1e-30))
            if err > OPT_TOL * scale:
                raise AssertionError(f"{name}: card vs CPU {err:.3e} on a "
                                     f"tensor of max |p| {scale:.3e}")
        moved = max(float((r - p0).abs().max())
                    for r, p0 in zip(sides["cpu"][0], params))
        results[name] = {"ms": sides[DEVICE][1], "rel_err": worst,
                         "moved": moved}
    lbfgs_ps = [torch.nn.Parameter(p.to(DEVICE, copy=True)) for p in params]
    lbfgs = create_optimizer({"name": "LBFGS", **base}, lbfgs_ps)
    for p, g in zip(lbfgs_ps, grads[0]):
        p.grad = g.to(DEVICE)
    try:
        lbfgs.step()
    except TypeError as e:
        if "'value', 'grad', and 'value_fn'" not in str(e):
            raise
    else:
        raise AssertionError("LBFGS stepped without value, grad, value_fn")
    n_params = sum(p.numel() for p in params)
    log(f"[phase 21] (c) {len(NEW_OPTIMIZERS)} optimizers, {OPT_STEPS} "
        f"updates of phase 9's {n_params} parameters, card vs CPU (limit "
        f"{OPT_TOL} of each tensor's max |p|): "
        + "; ".join(f"{k} {statistics.median(v['ms'][1:]):.2f} ms a step "
                    f"(median of steps 2-3; step 1 {v['ms'][0]:.2f}), rel "
                    f"err {v['rel_err']:.2e}"
                    for k, v in results.items())
        + "; LBFGS raises TypeError at step 1")
    torch.cuda.empty_cache()
    return {"launches": launches, "wall_s": wall, "losses": losses,
            "scores": [x[2] for x in scored],
            "step_ms": [r["ms"] for r in rec], "optimizers": results}


def phase_pipeline_rest(seed: int, workdir: str, cfg_train: dict,
                        standard: dict):
    """Phase 21: (a) LazyPredictor, (b) DSB2018, (c) training with the new
    optimizers and an instance metric."""
    lazy = _lazy_predict(seed, workdir, cfg_train["best"], standard)
    dsb = _dsb_predict(seed, workdir)
    train = _train_new_optimizers(seed, workdir, cfg_train)
    return {"lazy": lazy, "dsb": dsb, "train": train,
            "launches": {"lazy_predict3d": lazy["launches"],
                         "dsb_predict": dsb["launches"],
                         "train3d_optimizers": train["launches"]}}


# ---------------------------------------------------------------------------
# 23. Data-parallel training, its checkpoint and the profiler tooling
# ---------------------------------------------------------------------------

DP_STEPS = 3
DP_WORLD = 2
DP_3D_BATCH = 2                   # (b)'s global 'gcr' batch: 1 a rank
DP_U3P_RES, DP_U3P_BATCH = 256, 8  # (b)'s UNet-3+: 4 rows a rank
DP_STATS_TOL = 1e-5               # running statistics, 2 ranks vs 1
DP_TIMEOUT_S = 900
# (d): the trace must hold kernel 2's conv core and kernels 3a-3d
DP_TRACE_KERNELS = {
    "kernel 2": re.compile(r"conv_(halo|gather)_kernel"),
    "kernel 3a": re.compile(r"gn_stats_final_kernel"),
    "kernel 3b": re.compile(r"gn_affine_kernel"),
    "kernel 3d": re.compile(r"gn_bwd_dx_kernel"),
}


@contextlib.contextmanager
def _deterministic():
    """Deterministic algorithms, so that two runs of the same arithmetic
    give the same bits: cuDNN's (its weight gradient is not otherwise) and
    torch's (the UNet3D's 42 -> 85 nearest upsample is an ``index_select``,
    whose backward adds with atomics otherwise)."""
    import torch

    before = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark,
              torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
        True, False)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = before[:2]
        torch.use_deterministic_algorithms(before[2], warn_only=before[3])


def _dp_fit_3d(trainer):
    """``trainer.fit()`` instrumented: per-step records and the launches of
    the run (counts zeroed just before, read just after)."""
    import torch

    rec = []
    _instrument(trainer, rec)
    torch.cuda.synchronize()
    _zero_counts()
    trainer.fit()
    torch.cuda.synchronize()
    return rec, _counts()


def _dp_train_2d(trainer, stats_at=()):
    """``trainer.train()`` instrumented; the kernel-1 launches of the run."""
    import torch

    from mdeical_image_segmentation_tpu_torch.ops import fused_conv

    rec = []
    _instrument_2d(trainer, rec, stats_at=stats_at)
    torch.cuda.synchronize()
    fused_conv.fused_double2d.launches = 0
    trainer.train()
    torch.cuda.synchronize()
    return rec, fused_conv.fused_double2d.launches


def _dp_gaps(label, rec, ref, loss_tols=LOSS_TOLS, norm_tol=GRAD_NORM_TOL,
             mean_of=None):
    """Relative loss gaps of ``DP_STEPS`` steps and the step-1 grad-norm
    gap of ``rec`` against ``ref`` (``mean_of``: the ranks' records, whose
    mean loss is held), logged; raises beyond the limits.  Returns whether
    every value was equal to the bit."""
    losses = ([statistics.fmean(r[i]["loss"] for r in mean_of)
               for i in range(DP_STEPS)] if mean_of
              else [r["loss"] for r in rec[:DP_STEPS]])
    want = [r["loss"] for r in ref[:DP_STEPS]]
    rels = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
    norm = abs(rec[0]["grad_norm"] - ref[0]["grad_norm"]) / ref[0][
        "grad_norm"]
    bit = losses == want and rec[0]["grad_norm"] == ref[0]["grad_norm"]
    log(f"  {label}: losses {[f'{v:.7f}' for v in losses]} against "
        f"{[f'{v:.7f}' for v in want]}, rel gaps "
        f"{[f'{v:.2e}' for v in rels]} (limits {loss_tols}); step-1 grad "
        f"norm {rec[0]['grad_norm']:.7e} against {ref[0]['grad_norm']:.7e}"
        f" (rel {norm:.2e}, limit {norm_tol}); equal to the bit: {bit}")
    if any(r > t for r, t in zip(rels, loss_tols)) or norm > norm_tol:
        raise AssertionError(f"{label}: losses {rels}, grad norm {norm} "
                             "beyond the limits")
    return bit


def dp_gloo_runs(seed: int, workdir: str, mesh):
    """(b)'s two trainings over ``mesh``, 3 steps each from the same
    weights: phase 9's UNet3D with ``DiceLoss`` at a global batch of
    ``DP_3D_BATCH``, and the UNet-3+ (BatchNorm) at ``DP_U3P_RES``² in
    float32 with its hybrid ``segmentation_loss`` at a global batch of
    ``DP_U3P_BATCH``.  The losses, step-1 grad norms, the UNet-3+'s running
    statistics after steps 1 and 3 and the 3D kernels' launches."""
    import torch

    setup = UNet3DTraining(seed, os.path.join(workdir, "dp_3d"))
    setup.batch_size = DP_3D_BATCH
    setup.cfg = {**setup.cfg, "loss": {"name": "DiceLoss"}}
    trainer = setup.trainer("dp_3d", max_num_iterations=DP_STEPS - 1,
                            validate_after_iters=1000, log_after_iters=1000,
                            mesh=mesh)
    rec3, launches = _dp_fit_3d(trainer)
    del trainer
    torch.cuda.empty_cache()
    u3p = UNet2DTraining(seed, os.path.join(workdir, "dp_u3p"),
                         unet_type="UNet_3Plus", resolution=DP_U3P_RES,
                         channels=3, n_train=2 * DP_U3P_BATCH, n_eval=0,
                         batch=DP_U3P_BATCH // mesh.size)
    trainer = u3p.trainer("dp_u3p", "float32", max_steps=DP_STEPS,
                          eval_strategy="no", save_steps=0, augment=False,
                          mesh=mesh)
    rec2, _ = _dp_train_2d(trainer, stats_at=(1, DP_STEPS))
    del trainer
    torch.cuda.empty_cache()
    keep = ("loss", "grad_norm", "ms", "stats")
    return {"3d": [{k: r.get(k) for k in keep} for r in rec3],
            "u3p": [{k: r.get(k) for k in keep} for r in rec2],
            "launches": launches}


def dp_worker(rank: int, world: int, port: int, out: str) -> int:
    """One rank of (b): gloo over CUDA tensors on the one card (NCCL
    refuses two ranks on one device); writes ``out/rank<rank>.pkl``."""
    import pickle

    import torch

    from mdeical_image_segmentation_tpu_torch.parallel import (
        distributed,
        make_mesh,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.initialize(f"localhost:{port}", world, rank, backend="gloo")
    try:
        res = dp_gloo_runs(SEED, os.path.join(out, f"rank{rank}"),
                           make_mesh())
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dp_ranks(out: str, world: int, flag: str = "--dp-worker",
              timeout_s: float = None):
    """Run the ranks of phase 23 (b) (``flag`` ``--dp-worker``) or phase 24
    (``--spatial-worker``) as processes of this script; every one is
    waited for, or killed past ``timeout_s`` (``DP_TIMEOUT_S``)."""
    import pickle

    port = _free_port()
    os.makedirs(out, exist_ok=True)
    logs = [os.path.join(out, f"rank{rank}.log") for rank in range(world)]
    procs = []
    try:
        for rank, path in enumerate(logs):
            with open(path, "w") as f:  # a file: a full pipe would block
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     flag, str(rank), str(world), str(port), out],
                    stdout=f, stderr=subprocess.STDOUT, cwd=ROOT))
        deadline = time.time() + (timeout_s or DP_TIMEOUT_S)
        for p in procs:
            p.wait(timeout=max(deadline - time.time(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, path) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            with open(path) as f:
                text = f.read()
            raise AssertionError(f"{flag} rank {rank} failed (rc "
                                 f"{p.returncode}):\n{text[-4000:]}")
    res = []
    for rank in range(world):
        with open(os.path.join(out, f"rank{rank}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res


def phase_data_parallel(seed: int, workdir: str):
    """(a) a world of 1 over NCCL: phase 9's UNetTrainer and phase 11's
    base-64 UNet Trainer for 3 steps with ``mesh=make_mesh()`` (DDP)
    against the same runs without a mesh; (c) ``dist_ckpt``: 2 steps, a
    save, a resumed trainer's step 3 against the uninterrupted one; (d)
    ``trace`` of a DDP step, ``StepTimer`` and ``device_memory_summary``;
    (b) two ranks on the one card over gloo against one process holding
    the whole batch.  Returns the numbers to print and the launches."""
    import numpy as np
    import torch

    from mdeical_image_segmentation_tpu_torch.data.loaders import (
        VolumeLoader,
    )
    from mdeical_image_segmentation_tpu_torch.parallel import (
        distributed,
        make_mesh,
    )
    from mdeical_image_segmentation_tpu_torch.train import profiling
    from mdeical_image_segmentation_tpu_torch.train.dist_ckpt import (
        DistCheckpointer,
    )

    res = {"launches": {}}
    convs = 14  # phase 9's UNet3D: 2 SingleConvs in each of 7 blocks
    want3 = {"gcr_conv3d": convs, "gn_stats": convs, "gn_affine": convs,
             "gn_bwd_reduce": convs, "gn_bwd_dx": convs - 1,
             "overlap_add": 0}
    setup = UNet3DTraining(seed, os.path.join(workdir, "dp_a"))
    setup2d = UNet2DTraining(seed, os.path.join(workdir, "dp_a2d"))
    kw3 = dict(max_num_iterations=DP_STEPS - 1, validate_after_iters=1000,
               log_after_iters=1000)
    kw2 = dict(max_steps=DP_STEPS, eval_strategy="no", save_steps=0,
               augment=True)
    log(f"[phase 23] (a) a world of 1 over NCCL: phase 9's UNetTrainer "
        f"(fp32, TF32 off) and phase 11's Trainer (base-64 UNet, bf16, "
        f"batch {TRAIN_BATCH_2D}), {DP_STEPS} steps with and without "
        "mesh=make_mesh(), deterministic algorithms")
    runs = {}
    with _deterministic():
        for leg in ("no mesh", "DDP"):
            if leg == "DDP":
                distributed.initialize(f"localhost:{_free_port()}", 1, 0)
                mesh = make_mesh()
            else:
                mesh = None
            t = setup.trainer(f"dp_a_{leg[:2]}", mesh=mesh, **kw3)
            rec3, launches3 = _dp_fit_3d(t)
            if leg == "DDP" and not isinstance(
                    t._ddp, torch.nn.parallel.DistributedDataParallel):
                raise AssertionError("the mesh trainer is not under DDP")
            del t
            torch.cuda.empty_cache()
            t = setup2d.trainer(f"dp_a2d_{leg[:2]}", mesh=mesh, **kw2)
            rec2, launches2 = _dp_train_2d(t)
            del t
            torch.cuda.empty_cache()
            runs[leg] = (rec3, launches3, rec2, launches2)
    for leg, (rec3, launches3, rec2, launches2) in runs.items():
        for i, r in enumerate(rec3):
            if r["launches"] != want3 or not np.isfinite(r["loss"]):
                raise AssertionError(f"(a) {leg} 3D step {i + 1}: {r}, "
                                     f"want launches {want3}")
        if launches2 != 18 * len(rec2) or len(rec2) != DP_STEPS:
            raise AssertionError(f"(a) {leg} 2D: {launches2} kernel-1 "
                                 f"launches in {len(rec2)} steps, want 18 "
                                 "a step")
        ms3 = statistics.median(r["ms"] for r in rec3[1:])
        ms2 = statistics.median(r["ms"] for r in rec2[1:])
        log(f"  {leg}: 3D step median {ms3:.1f} ms (steps 2-3), 2D step "
            f"median {ms2:.2f} ms; launches 3D {launches3}, kernel 1 "
            f"{launches2}")
        res[f"step_ms_3d {leg}"], res[f"step_ms_2d {leg}"] = ms3, ms2
    res["bit_equal_3d"] = _dp_gaps("(a) 3D, DDP vs no mesh",
                                   runs["DDP"][0], runs["no mesh"][0])
    res["bit_equal_2d"] = _dp_gaps("(a) 2D, DDP vs no mesh",
                                   runs["DDP"][2], runs["no mesh"][2])
    res["launches"]["dp_3d_ddp"] = runs["DDP"][1]
    res["launches"]["dp_2d_ddp"] = runs["DDP"][3]

    # (c) dist_ckpt: an epoch of 2 patches in order, so that the resumed
    # trainer's step (the next epoch's first batch) is the uninterrupted
    # run's step 3
    log("[phase 23] (c) dist_ckpt: 2 steps, a save, resume, step 3")
    two = [setup.train_ds[i] for i in range(2)]

    def ckpt_trainer(name, iterations, **kw):
        loaders = {"train": VolumeLoader(two, 1),
                   "val": VolumeLoader(setup.val_ds, 1)}
        return _make_trainer(setup.model_cfg, setup.cfg, loaders,
                             os.path.join(workdir, "dp_c", name),
                             kw.pop("pre_trained", None), seed=seed,
                             mesh=mesh, max_num_iterations=iterations,
                             validate_after_iters=1000, log_after_iters=1000,
                             **kw)

    with _deterministic():
        full = ckpt_trainer("full", DP_STEPS - 1,
                            pre_trained=setup.checkpoint)
        full_rec, _ = _dp_fit_3d(full)
        first = ckpt_trainer("first", DP_STEPS - 2,
                             pre_trained=setup.checkpoint)
        _dp_fit_3d(first)
        ckpt_dir = os.path.join(workdir, "dp_c", "dcp")
        t0 = time.perf_counter()
        DistCheckpointer(ckpt_dir).save(first.checkpoint_state())
        save_s = time.perf_counter() - t0
        del first
        t0 = time.perf_counter()
        resumed = ckpt_trainer("resumed", DP_STEPS - 2, resume=ckpt_dir)
        load_s = time.perf_counter() - t0
        resumed_rec, launches_c = _dp_fit_3d(resumed)
    same_params = all(torch.equal(a, b) for a, b in zip(
        full.model.state_dict().values(),
        resumed.model.state_dict().values()))
    log(f"  step 3: uninterrupted loss {full_rec[2]['loss']:.9f}, resumed "
        f"{resumed_rec[0]['loss']:.9f}; parameters and statistics after it "
        f"equal to the bit: {same_params}; save {save_s:.2f} s, resume "
        f"{load_s:.2f} s")
    if (len(resumed_rec) != 1 or resumed_rec[0]["loss"] != full_rec[2]["loss"]
            or not same_params):
        raise AssertionError("(c) the resumed step 3 differs from the "
                             "uninterrupted one")
    res["launches"]["dp_resume"] = launches_c
    res["ckpt_save_s"], res["ckpt_load_s"] = save_s, load_s
    del full, resumed
    torch.cuda.empty_cache()

    # (d) the tooling on a DDP step
    log("[phase 23] (d) trace, StepTimer, device_memory_summary")
    t = setup.trainer("dp_d", mesh=mesh, **kw3)
    batches = t._device_batches(t.loaders["train"])
    timer = profiling.StepTimer()
    trace_dir = os.path.join(workdir, "dp_trace")
    for i in range(DP_STEPS + 1):
        input, target, weight, t._split = next(batches)
        with (profiling.trace(trace_dir) if i == DP_STEPS
              else contextlib.nullcontext()):
            with profiling.ProfiledSection("dp_step"):
                t._train_step(input, target, weight)
            timer.tick()
            timer.synced_lap()
    with open(os.path.join(trace_dir, f"trace_{os.getpid()}.json")) as f:
        names = {e.get("name") or "" for e in json.load(f)["traceEvents"]}
    found = {k: sorted(n for n in names if pat.search(n))[:1]
             for k, pat in DP_TRACE_KERNELS.items()}
    partial = {n for n in names if "gn_partial_kernel" in n}
    summary, memory = timer.summary(), profiling.device_memory_summary()
    log(f"  trace: {len(names)} event names, {found}, gn_partial_kernel "
        f"instantiations (3a and 3c) {len(partial)}, dp_step range "
        f"{'dp_step' in names}; StepTimer {summary}; memory {memory}")
    if (not all(found.values()) or len(partial) < 2
            or "dp_step" not in names):
        raise AssertionError("(d) the trace lacks kernels 2 / 3a-3d or the "
                             "section")
    if not (summary and all(np.isfinite(v) for v in summary.values())
            and memory and all(np.isfinite(v) for m in memory
                               for k, v in m.items() if k != "device")):
        raise AssertionError(f"(d) {summary}, {memory}")
    res["step_timer"], res["memory"] = summary, memory
    del t, batches
    torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()

    # (b) two ranks on the one card, gloo, against one process
    log(f"[phase 23] (b) {DP_WORLD} processes on the card over gloo "
        f"against one process with the whole batch: phase 9's UNet3D with "
        f"DiceLoss, global batch {DP_3D_BATCH}; UNet_3Plus at "
        f"{DP_U3P_RES}², fp32, segmentation_loss, global batch "
        f"{DP_U3P_BATCH}")
    ref = dp_gloo_runs(seed, os.path.join(workdir, "dp_b1"),
                       make_mesh())
    t0 = time.perf_counter()
    ranks = _dp_ranks(os.path.join(workdir, "dp_b"), DP_WORLD)
    wall = time.perf_counter() - t0
    _dp_gaps("(b) 3D 'gcr' + Dice, rank 0 vs one process", ranks[0]["3d"],
             ref["3d"])
    _dp_gaps("(b) 3D, the ranks' mean loss", ranks[0]["3d"], ref["3d"],
             mean_of=[r["3d"] for r in ranks])
    _dp_gaps("(b) UNet-3+ + segmentation_loss, the ranks' mean loss",
             ranks[0]["u3p"], ref["u3p"], mean_of=[r["u3p"] for r in ranks])
    for step in (1, DP_STEPS):
        rels = [_stats_rel(r["u3p"][step - 1]["stats"],
                           ref["u3p"][step - 1]["stats"]) for r in ranks]
        log(f"  UNet-3+ running statistics after step {step}, each rank vs "
            f"one process: {[f'{v:.2e}' for v in rels]} of max |value|"
            + (f" (limit {DP_STATS_TOL})" if step == 1 else
               " (after the updates; printed)"))
        if step == 1 and max(rels) > DP_STATS_TOL:
            raise AssertionError(f"(b) running statistics {rels}")
    for k in KERNELS_3D:
        if sum(r["launches"][k] for r in ranks) != (
                DP_WORLD * ref["launches"][k]):
            raise AssertionError(f"(b) {k}: rank launches "
                                 f"{[r['launches'][k] for r in ranks]}, one "
                                 f"process {ref['launches'][k]}")
    ms = [statistics.median(s["ms"] for s in r["3d"][1:]) for r in ranks]
    log(f"  ranks' 3D step medians {[f'{v:.1f}' for v in ms]} ms (two "
        f"processes sharing the card, gloo through the host) against "
        f"{statistics.median(s['ms'] for s in ref['3d'][1:]):.1f} ms in one "
        f"process; both ranks in {wall:.1f} s")
    res["launches"]["dp_3d_gloo"] = {
        k: sum(r["launches"][k] for r in ranks) for k in KERNELS_3D}
    res["gloo_step_ms_3d"] = ms
    return res


# -- phase 24: spatially sharded 3D training (parallel/spatial.py) ----------

# configs/unet3d_train.yml's patch is 80x170x170; split over 2 ranks on H,
# 170 / 2 + 2 * 16 = 117 rows is not divisible by 2**(4 - 1) = 8, and the
# cross-shard GroupNorm refuses it at the deepest level (no halo that is a
# multiple of 8 mends it).  At H = 176 a rank's 88 rows pad to 120 = 8 * 15,
# and a world of 1 pads to 208 = 8 * 26.
SPATIAL_VOLUME = (80, 176, 170)
# cli/train3d.py's leg: the yml's RandomRotate90 turns a 176x170 patch into
# 170x176 on an odd quarter-turn, and H = 170 does not split; a square
# 176x176 patch keeps H at 176 whatever the turn
SPATIAL_TRAIN_VOLUME = (80, 176, 176)
SPATIAL_HALO = 16
# the 4-level UNet3D sees about +-50 rows (2 convs a level at scales 1-8 on
# the way down and 4-1 on the way up, the pools' offsets), more than a halo
# of 16: rows near a slab's edge then see other context than in a world of
# 1, and under cross-shard statistics that reaches every row through the
# global sums.  The mesh width's invariance holds at a halo that covers the
# field: 48 (a multiple of 8; 88 + 96 = 184 = 8 * 23, 176 + 96 = 8 * 34)
SPATIAL_EXACT_HALO = 48
SPATIAL_AXIS = 2        # H of (N, D, H, W, C)
SPATIAL_WORLD = 2
SPATIAL_STEPS = 3
SPATIAL_TIMEOUT_S = 600
# the windowed instantiations of kernels 3a and 3d in a profiler trace
SPATIAL_WINDOWED = {"3a": re.compile(r"gn_partial_kernel<float, false, true>"),
                    "3d": re.compile(r"gn_bwd_dx_kernel<float, true>")}


class SpatialSetup:
    """Phase 24's inputs, the same in every process: the UNet3D of
    configs/unet3d_train.yml (weights from a CPU generator seeded with
    ``seed``, as ``create_trainer`` draws them), one seeded 1x80x176x170
    volume and its label, and (``write_volumes``) a train and a validation
    volume of ``SPATIAL_TRAIN_VOLUME`` as HDF5 files for
    ``cli/train3d.py``."""

    def __init__(self, seed: int, workdir: str):
        self.seed, self.workdir = seed, workdir
        os.makedirs(workdir, exist_ok=True)
        self.cfg = read_yaml_subset(TRAIN_YML)
        self.model_cfg = self.cfg["model"]
        self.raw = seeded_volume(SPATIAL_VOLUME, seed + 6)
        self.label = foreground_label(self.raw)
        self.train_h5 = os.path.join(workdir, "spatial_train.h5")
        self.val_h5 = os.path.join(workdir, "spatial_val.h5")

    def write_volumes(self):
        for path, seed in ((self.train_h5, self.seed + 7),
                           (self.val_h5, self.seed + 8)):
            raw = seeded_volume(SPATIAL_TRAIN_VOLUME, seed)
            write_h5_volume(path, raw, foreground_label(raw))

    def model(self):
        import torch

        from mdeical_image_segmentation_tpu_torch.models import get_model

        return get_model(self.model_cfg, generator=torch.Generator()
                         .manual_seed(self.seed)).to(DEVICE)

    def slabs(self, group=None):
        """This rank's slabs of the volume and of its label, (1, D, h, W,
        1) float32 on the card."""
        import torch

        from mdeical_image_segmentation_tpu_torch.parallel import shard_slab

        return tuple(shard_slab(torch.from_numpy(
            v[None, ..., None].astype("float32")).to(DEVICE), group,
            SPATIAL_AXIS).contiguous() for v in (self.raw, self.label))


def _bce(out, y):
    import torch.nn.functional as F

    return F.binary_cross_entropy_with_logits(out, y)


# the forwards of (b): (name, halo, cross_shard_norm)
SPATIAL_FORWARDS = (("per_slab", SPATIAL_HALO, False),
                    ("cross_shard", SPATIAL_HALO, True),
                    ("cross_shard_exact", SPATIAL_EXACT_HALO, True))


def spatial_forwards(setup, group=None):
    """This rank's output slab of ``spatial_sharded_apply`` of the model in
    eval mode, for each of ``SPATIAL_FORWARDS``."""
    import torch

    from mdeical_image_segmentation_tpu_torch.parallel import (
        spatial_sharded_apply,
    )

    model = setup.model().eval()
    x, _ = setup.slabs(group)
    out = {}
    with torch.no_grad():
        for name, halo, mode in SPATIAL_FORWARDS:
            out[name] = spatial_sharded_apply(
                model, x, group, halo=halo, shard_axis=SPATIAL_AXIS,
                cross_shard_norm=mode)
    torch.cuda.synchronize()
    return out


def spatial_steps(setup, group=None, halo=SPATIAL_HALO, sharded=True):
    """``SPATIAL_STEPS`` steps of ``make_spatial_train_step`` (cross-shard
    statistics, BCE with logits, the yml's Adam) on this rank's slab with
    ``halo``, or with ``sharded`` False the same model and optimizer
    stepping on the whole unpadded volume: per step the loss (the ranks'
    mean), ms, the launches and, after step 1, the global grad norm; and
    the peak memory (GiB)."""
    import torch

    from mdeical_image_segmentation_tpu_torch.parallel import (
        make_spatial_train_step,
    )
    from mdeical_image_segmentation_tpu_torch.train.optimizers import (
        create_optimizer,
    )

    model = setup.model().train()
    optimizer = create_optimizer(setup.cfg["optimizer"], model.parameters())
    if sharded:
        step = make_spatial_train_step(
            model, _bce, optimizer, group, halo=halo,
            shard_axis=SPATIAL_AXIS, cross_shard_norm=True, seed=setup.seed)
        x, y = setup.slabs(group)
    else:
        x, y = setup.slabs()

        def step(x, y):
            optimizer.zero_grad(set_to_none=True)
            loss = _bce(model(x), y)
            loss.backward()
            optimizer.step()
            return loss.detach()
    rec = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(SPATIAL_STEPS):
        before, t0 = _counts(), time.perf_counter()
        loss = float(step(x, y))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = _counts()
        norm = None
        if i == 0:
            norm = torch.sqrt(sum(p.grad.double().square().sum()
                                  for p in model.parameters()
                                  if p.grad is not None)).item()
        rec.append({"loss": loss, "ms": ms, "grad_norm": norm,
                    "launches": {k: after[k] - before[k] for k in after}})
    peak = torch.cuda.max_memory_allocated() / 2**30
    del model, optimizer, x, y
    torch.cuda.empty_cache()
    return rec, peak


def spatial_train3d(setup, run_dir):
    """``cli/train3d.py`` on configs/unet3d_train.yml with the ``parallel:``
    keys (halo 16, H, cross-shard statistics) given as overrides, the
    yml's loss, transforms and optimizer, each volume of
    ``SPATIAL_TRAIN_VOLUME`` one patch: 3 steps and a validation at step
    3.  Per-step records, the launches of the run and the files it
    wrote."""
    import torch

    from mdeical_image_segmentation_tpu_torch.cli import train3d
    from mdeical_image_segmentation_tpu_torch.train import trainer3d

    patch = repr(list(SPATIAL_TRAIN_VOLUME))
    argv = ["--config", TRAIN_YML,
            "--loaders.train.file_paths", repr([setup.train_h5]),
            "--loaders.val.file_paths", repr([setup.val_h5]),
            "--loaders.train.slice_builder.patch_shape", patch,
            "--loaders.train.slice_builder.stride_shape", patch,
            "--loaders.val.slice_builder.patch_shape", patch,
            "--loaders.val.slice_builder.stride_shape", patch,
            "--trainer.checkpoint_dir", run_dir,
            "--trainer.max_num_iterations", str(SPATIAL_STEPS - 1),
            "--trainer.validate_after_iters", str(SPATIAL_STEPS),
            "--trainer.log_after_iters", "1",
            "--parallel.spatial_halo", str(SPATIAL_HALO),
            "--parallel.spatial_shard_axis", str(SPATIAL_AXIS),
            "--parallel.spatial_cross_shard_norm", "true"]
    rec, made = [], []
    create = trainer3d.create_trainer

    def instrumented(config):
        t = create(config)
        _instrument(t, rec)
        made.append(t)
        return t

    trainer3d.create_trainer = instrumented
    try:
        torch.cuda.synchronize()
        _zero_counts()
        train3d.main(argv)
        torch.cuda.synchronize()
        launches = _counts()
    finally:
        trainer3d.create_trainer = create
    t = made[0]
    info = {"spatial": (t.spatial_halo, t.spatial_shard_axis,
                        t.spatial_cross_shard_norm),
            "ddp": t._ddp is not t.model,
            "process_shard": getattr(t.loaders["train"], "process_shard",
                                     None)}
    files = ([] if not os.path.isdir(run_dir) else
             sorted(os.path.relpath(os.path.join(d, f), run_dir)
                    for d, _, fs in os.walk(run_dir) for f in fs))
    del t, made
    torch.cuda.empty_cache()
    keep = ("loss", "ms", "launches")
    return {"rec": [{k: r[k] for k in keep} for r in rec],
            "launches": launches, "files": files, "info": info}


def spatial_gloo_runs(seed: int, out: str, rank: int):
    """(b)-(c) on one rank of the gloo world: the forward slabs (numpy),
    the sharded steps at the covering halo and ``cli/train3d.py``."""
    setup = SpatialSetup(seed, out)
    fwd = {m: v.cpu().numpy() for m, v in spatial_forwards(setup).items()}
    steps, peak = spatial_steps(setup, halo=SPATIAL_EXACT_HALO)
    train = spatial_train3d(setup, os.path.join(out, f"train3d_rank{rank}"))
    return {"forward": fwd, "steps": steps, "peak": peak, "train3d": train}


def spatial_worker(rank: int, world: int, port: int, out: str) -> int:
    """One rank of phase 24 (b)-(c): gloo over CUDA tensors on the one card
    (NCCL refuses two ranks on one device); writes ``out/rank<rank>.pkl``."""
    import pickle

    import torch

    from mdeical_image_segmentation_tpu_torch.parallel import distributed

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.initialize(f"localhost:{port}", world, rank, backend="gloo")
    try:
        res = spatial_gloo_runs(SEED, out, rank)
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def _slab_gn_shapes(setup, padded_h: int):
    """(shape, window) of every GroupNorm input of the model on a slab
    padded to ``padded_h`` rows, the window its interior rows under
    cross-shard statistics (one no-grad forward of zeros)."""
    import torch

    from mdeical_image_segmentation_tpu_torch.ops import norm

    model = setup.model().eval()
    shapes: set = set()
    handles = _record_shapes(model, shapes)
    d, _, w = SPATIAL_VOLUME
    with torch.no_grad():
        model(torch.zeros((1, d, padded_h, w, 1), device=DEVICE))
    for h in handles:
        h.remove()
    del model
    torch.cuda.empty_cache()
    out = []
    with norm.cross_shard_group_stats(None, SPATIAL_AXIS, SPATIAL_HALO,
                                      padded_h):
        for shape in sorted(s[1] for s in shapes if s[0] == "stats"):
            site = norm.cross_shard_site(torch.empty(shape, device="meta"))
            out.append((shape, site.window))
    return out


def phase_spatial_kernels(seed: int, setup):
    """(a) kernels 3a and 3d with the interior window at every GroupNorm
    input of the 2-rank step's slab, fp32 and bf16, against their windowed
    plain versions (phase 6's and phase 7's limits), 3a the same bits on
    two calls; the event window and device time of the windowed and the
    whole-slab launch, the plain version's, ``torch.var_mean`` of the
    window's view for 3a, and the bound (the bytes of the rows each reads
    and writes)."""
    import torch

    from mdeical_image_segmentation_tpu_torch.ops import norm

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    slab_h = SPATIAL_VOLUME[1] // SPATIAL_WORLD + 2 * SPATIAL_HALO
    cases = _slab_gn_shapes(setup, slab_h)
    sums: dict = {}
    errs = {"gn_stats": 0.0, "gn_bwd_dx": 0.0}
    log(f"[phase 24] (a) kernels 3a and 3d windowed at the "
        f"{len(cases)} GroupNorm inputs of a 2-rank slab (1x80x{slab_h}x170 "
        f"at the input): shape, window, max err, ms window / whole / plain "
        f"/ library, device windowed / whole, bound")
    for dtype in (torch.float32, torch.bfloat16):
        for shape, window in cases:
            n, c = shape[0], shape[-1]
            axis, lo, hi = window
            rows = 1
            for a, e in enumerate(shape[1:-1], start=1):
                rows *= (hi - lo) if a == axis else e
            x = _rand(gen, shape, dtype, 2.0, 1.0)
            g = _rand(gen, shape, dtype)
            item = x.element_size()
            sums_w = norm.gn_channel_sums(x, window)
            _same_bits(f"gn_stats window {shape} {dtype}", sums_w,
                       norm.gn_channel_sums(x, window))
            got = norm.group_stats(*sums_w, c, rows, 1e-5)
            want = norm.group_stats(*norm.gn_channel_sums_reference(
                x, window), c, rows, 1e-5)
            err = max(_compare(f"gn_stats window {shape} {what}", a_, b_,
                               GN_TOL)
                      for what, a_, b_ in zip(("mean", "inv"), got, want))
            errs["gn_stats"] = max(errs["gn_stats"], err)
            spatial = tuple(range(1, x.ndim - 1))
            fn = lambda: norm.gn_channel_sums(x, window)
            full = lambda: norm.gn_channel_sums(x)
            k_ms, f_ms, p_ms, l_ms = _time_turns(
                fn, full, lambda: norm.gn_channel_sums_reference(x, window),
                lambda: torch.var_mean(x.narrow(axis, lo, hi - lo),
                                       dim=spatial, correction=0))
            k_dev, f_dev = _device_ms(fn, 2), _device_ms(full, 2)
            work = _elementwise(n * rows * c, 3, n * rows * c * item
                                + 8 * n * c)
            bound = _bound_ms(*work)[0]
            _add_sums(sums, ("gn_stats", dtype), window=k_ms, whole=f_ms,
                      plain=p_ms, library=l_ms, device=k_dev,
                      whole_device=f_dev, bound=bound)
            log(f"  3a {str(dtype)[6:]:8s} {str(shape):24s} {window} "
                f"{err:.2e} {k_ms:.4f} / {f_ms:.4f} / {p_ms:.4f} / "
                f"{l_ms:.4f} ms, device {_ms(k_dev)} / {_ms(f_dev)}, bound "
                f"{bound:.4f}")
            a, cc, dd = (torch.randn((n, c), device=DEVICE, generator=gen)
                         for _ in range(3))
            err = _compare(f"gn_bwd_dx window {shape}",
                           norm.gn_bwd_dx(x, g, a, cc, dd, window),
                           norm.gn_bwd_dx_reference(x, g, a, cc, dd, window),
                           BF16_TOL if dtype == torch.bfloat16
                           else AFFINE_FP32_TOL)
            errs["gn_bwd_dx"] = max(errs["gn_bwd_dx"], err)
            fn = lambda: norm.gn_bwd_dx(x, g, a, cc, dd, window)
            full = lambda: norm.gn_bwd_dx(x, g, a, cc, dd)
            k_ms, f_ms, p_ms = _time_turns(
                fn, full,
                lambda: norm.gn_bwd_dx_reference(x, g, a, cc, dd, window))
            k_dev, f_dev = _device_ms(fn), _device_ms(full)
            # g read and dx written on every row, x read on the interior
            work = _elementwise(x.numel(), 4, (2 * x.numel() + n * rows * c)
                                * item + 12 * n * c)
            bound = _bound_ms(*work)[0]
            _add_sums(sums, ("gn_bwd_dx", dtype), window=k_ms, whole=f_ms,
                      plain=p_ms, device=k_dev, whole_device=f_dev,
                      bound=bound)
            log(f"  3d {str(dtype)[6:]:8s} {str(shape):24s} {window} "
                f"{err:.2e} {k_ms:.4f} / {f_ms:.4f} / {p_ms:.4f} ms, device "
                f"{_ms(k_dev)} / {_ms(f_dev)}, bound {bound:.4f}")
            del x, g
            torch.cuda.empty_cache()
    out = {}
    for (kernel, dtype), t in sums.items():
        log(f"[phase 24] {kernel} windowed over the {t['n']:.0f} slab "
            f"shapes, {str(dtype)[6:]}: event window {t['window']:.4f} ms "
            f"(whole slab {t['whole']:.4f}), device {_ms(t['device'])} "
            f"(whole slab {_ms(t['whole_device'])}), plain {t['plain']:.4f}"
            + (f", torch.var_mean {t['library']:.4f}" if "library" in t
               else "") + f"; bound {t['bound']:.4f} ms (share: window "
            f"{_share(t['bound'], t['window'])}, device "
            f"{_share(t['bound'], t['device'])})")
        out.setdefault(kernel, {})[str(dtype)[6:]] = {
            "shapes": int(t["n"]), "max_abs_err": errs[kernel],
            "ms": t["window"], "plain_ms": t["plain"],
            "library_ms": t.get("library"),
            "device_ms": None if math.isnan(t["device"]) else t["device"],
            "whole_slab_ms": t["whole"],
            "whole_slab_device_ms": (None if math.isnan(t["whole_device"])
                                     else t["whole_device"]),
            "bound_ms": t["bound"], "bound_by": "bytes"}
    return out


def _windowed_in_trace(fn) -> dict:
    """{3a, 3d: whether a windowed instantiation ran} in a profiler trace
    of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    return {k: any(p.search(n) for n in names)
            for k, p in SPATIAL_WINDOWED.items()}


def phase_spatial(seed: int, workdir: str, phase9_step_ms: float):
    """(a) the windowed kernels; (b) ``spatial_sharded_apply`` of the
    UNet3D at full width on one 1x80x176x170 volume, halo 16, per-slab and
    cross-shard, in a world of 1 over NCCL and in two ranks over gloo on
    the card; (c) ``make_spatial_train_step`` (cross-shard, BCE) for 3
    steps and ``cli/train3d.py`` with the ``parallel:`` keys for 3 steps,
    in both worlds; (d) launches a step a rank.  Returns the numbers to
    print and the launches of each path."""
    import numpy as np
    import torch

    from mdeical_image_segmentation_tpu_torch.parallel import (
        distributed,
        halo_exchange,
        make_spatial_train_step,
        spatial_sharded_apply,
    )

    res = {"launches": {}}
    setup = SpatialSetup(seed, os.path.join(workdir, "spatial"))
    setup.write_volumes()
    res["window"] = phase_spatial_kernels(seed, setup)
    convs = 2 * (2 * setup.model_cfg["num_levels"] - 1)
    want = {"gcr_conv3d": convs, "gn_stats": convs, "gn_affine": convs,
            "gn_bwd_reduce": convs, "gn_bwd_dx": convs - 1, "overlap_add": 0}

    def check_steps(label, rec):
        for i, r in enumerate(rec):
            if r["launches"] != want or not np.isfinite(r["loss"]):
                raise AssertionError(f"{label} step {i + 1}: {r}, want "
                                     f"launches {want} and a finite loss")

    # (b) and (c) in a world of 1 over NCCL
    distributed.initialize(f"localhost:{_free_port()}", 1, 0)
    try:
        log(f"[phase 24] (b) spatial_sharded_apply, world of 1 over NCCL: "
            f"UNet3D of the train yml at full width, 1x{SPATIAL_VOLUME}, "
            f"halo {SPATIAL_HALO} on H (pads to "
            f"{SPATIAL_VOLUME[1] + 2 * SPATIAL_HALO} rows)")
        one = spatial_forwards(setup)
        model = setup.model().eval()
        x, _ = setup.slabs()
        with torch.no_grad():
            padded = model(halo_exchange(x, SPATIAL_HALO, SPATIAL_AXIS))
            mono = padded[:, :, SPATIAL_HALO:-SPATIAL_HALO]
            with plain_path():
                plain = spatial_sharded_apply(
                    model, x, halo=SPATIAL_HALO, shard_axis=SPATIAL_AXIS,
                    cross_shard_norm=True)
        for label, got, ref in (
                ("per-slab world of 1 vs the reflect-padded forward",
                 one["per_slab"], mono),
                ("cross-shard world of 1, kernels vs plain versions",
                 one["cross_shard"], plain)):
            err = (got - ref).abs().max().item()
            scale = max(1.0, ref.abs().max().item())
            log(f"  {label}: max |diff| {err:.3e} (limit {UNET3D_MAP_TOL} x "
                f"{scale:.3f})")
            if not torch.isfinite(got).all() or err > UNET3D_MAP_TOL * scale:
                raise AssertionError(f"(b) {label}: {err:.3e}")
        del model, x, padded, mono, plain
        one = {m: v.cpu().numpy() for m, v in one.items()}
        torch.cuda.empty_cache()

        log(f"[phase 24] (c) make_spatial_train_step, cross-shard, BCE with "
            f"logits, the yml's Adam, {SPATIAL_STEPS} steps, world of 1, "
            f"halo {SPATIAL_HALO} and {SPATIAL_EXACT_HALO}; the same model "
            "stepping on the unpadded volume")
        steps1, peak1 = spatial_steps(setup)
        check_steps("(c) world of 1", steps1)
        exact1, _ = spatial_steps(setup, halo=SPATIAL_EXACT_HALO)
        check_steps(f"(c) world of 1, halo {SPATIAL_EXACT_HALO}", exact1)
        plain1, plain_peak = spatial_steps(setup, sharded=False)
        ms1 = statistics.median(r["ms"] for r in steps1[1:])
        msu = statistics.median(r["ms"] for r in plain1[1:])
        losses = ", ".join(f"{r['loss']:.6f}" for r in steps1)
        log(f"  spatial step median {ms1:.1f} ms (steps 2-3; peak "
            f"{peak1:.2f} GiB), unsharded {msu:.1f} ms (peak "
            f"{plain_peak:.2f} GiB), phase 9's step {phase9_step_ms:.1f} ms; "
            f"losses {losses}; launches a step {steps1[0]['launches']}")
        res.update(step_ms_w1=ms1, unsharded_step_ms=msu, peak_gib_w1=peak1,
                   phase9_step_ms=phase9_step_ms)
        res["launches"]["spatial_step_w1"] = {
            k: _counts_from(steps1)[k] + _counts_from(exact1)[k]
            for k in KERNELS_3D}
        # the windowed instantiations ran in a step
        model = setup.model().train()
        opt = torch.optim.SGD(model.parameters(), lr=0.0)
        step = make_spatial_train_step(
            model, _bce, opt, halo=SPATIAL_HALO, shard_axis=SPATIAL_AXIS,
            cross_shard_norm=True)
        xs, ys = setup.slabs()
        found = _windowed_in_trace(lambda: step(xs, ys))
        log(f"  windowed 3a / 3d instantiations in a traced step: {found}")
        if not all(found.values()):
            raise AssertionError(f"(d) windowed kernels missing: {found}")
        del model, opt, step, xs, ys
        torch.cuda.empty_cache()

        log(f"[phase 24] (c) cli/train3d.py with --parallel.spatial_halo "
            f"{SPATIAL_HALO} (cross-shard), world of 1: {SPATIAL_STEPS} "
            "steps, a validation")
        train1 = spatial_train3d(setup, os.path.join(setup.workdir,
                                                     "train3d_w1"))
        check_steps("(c) train3d world of 1", train1["rec"])
        losses = ", ".join(f"{r['loss']:.6f}" for r in train1["rec"])
        log(f"  losses {losses}; launches {train1['launches']}; "
            f"{train1['info']}")
        res["launches"]["spatial_train3d_w1"] = train1["launches"]
    finally:
        torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()

    # (b) and (c) in two ranks over gloo on the one card
    log(f"[phase 24] (b)-(c) {SPATIAL_WORLD} processes on the card over gloo "
        "(halos staged through the host), each with its slab")
    t0 = time.perf_counter()
    ranks = _dp_ranks(setup.workdir, SPATIAL_WORLD, "--spatial-worker",
                      SPATIAL_TIMEOUT_S)
    wall = time.perf_counter() - t0
    res["forward_gap"] = {}
    for name, halo, _ in SPATIAL_FORWARDS:
        joined = np.concatenate([r["forward"][name] for r in ranks],
                                axis=SPATIAL_AXIS)
        gap = np.abs(joined - one[name])
        scale = max(1.0, float(np.abs(one[name]).max()))
        # the rows within 48 of the slabs' shared edge, and the rest
        by_row = gap.max(axis=(0, 1, 3, 4))
        edge = SPATIAL_VOLUME[1] // SPATIAL_WORLD
        near = np.zeros(by_row.shape, bool)
        near[max(0, edge - 48):edge + 48] = True
        limit = (f"limit {UNET3D_MAP_TOL} x {scale:.3f}"
                 if name == "cross_shard_exact" else "printed")
        log(f"  {name}, halo {halo}: 2 ranks vs the world of 1, max |diff| "
            f"{gap.max():.3e} ({limit}), mean {gap.mean():.3e}; within 48 "
            f"rows of the slabs' edge {by_row[near].max():.3e}, farther "
            f"{by_row[~near].max():.3e}")
        if not np.isfinite(joined).all():
            raise AssertionError(f"(b) {name}: non-finite output")
        if name == "cross_shard_exact" and gap.max() > UNET3D_MAP_TOL * scale:
            raise AssertionError(f"(b) {name} 2 ranks vs 1: {gap.max():.3e}")
        res["forward_gap"][name] = {"max": float(gap.max()),
                                    "mean": float(gap.mean())}
    for rank, r in enumerate(ranks):
        check_steps(f"(c) rank {rank}", r["steps"])
        check_steps(f"(c) train3d rank {rank}", r["train3d"]["rec"])
    _dp_gaps(f"(c) 2 ranks vs the world of 1, halo {SPATIAL_EXACT_HALO}, "
             "the ranks' mean loss", ranks[0]["steps"], exact1)
    if any([s["loss"] for s in r["steps"]] != [s["loss"] for s in
                                                ranks[0]["steps"]]
           for r in ranks):
        raise AssertionError("(c) the ranks' mean losses differ by rank")
    losses = [[s["loss"] for s in r["train3d"]["rec"]] for r in ranks]
    log(f"  train3d: losses by rank {losses}; files rank 0 "
        f"{ranks[0]['train3d']['files']}, rank 1 "
        f"{ranks[1]['train3d']['files']}; {ranks[0]['train3d']['info']}")
    if losses[0] != losses[1] or not np.isfinite(losses).all():
        raise AssertionError(f"(c) train3d losses by rank {losses}")
    if ("last_checkpoint.msgpack" not in ranks[0]["train3d"]["files"]
            or ranks[1]["train3d"]["files"]):
        raise AssertionError("(c) only rank 0 writes checkpoints and logs")
    info = ranks[0]["train3d"]["info"]
    if (info["spatial"] != (SPATIAL_HALO, SPATIAL_AXIS, True) or info["ddp"]
            or info["process_shard"] is not None):
        raise AssertionError(f"(c) the trainer's spatial mode: {info}")
    ms2 = [statistics.median(s["ms"] for s in r["steps"][1:]) for r in ranks]
    ms2_16 = [statistics.median(s["ms"] for s in r["train3d"]["rec"][1:])
              for r in ranks]
    ms1_48 = statistics.median(r["ms"] for r in exact1[1:])
    peaks = ", ".join(f"{r['peak']:.2f}" for r in ranks)
    log(f"  ranks' step medians, halo {SPATIAL_EXACT_HALO}: "
        f"{', '.join(f'{v:.1f}' for v in ms2)} ms (world of 1 "
        f"{ms1_48:.1f} ms); train3d at halo {SPATIAL_HALO} (steps 2-3, the "
        f"loader inside): {', '.join(f'{v:.1f}' for v in ms2_16)} ms (two "
        f"processes sharing the card, gloo through the host), peaks {peaks} "
        f"GiB; both ranks in {wall:.1f} s")
    res.update(gloo_step_ms_exact=ms2, step_ms_w1_exact=ms1_48,
               gloo_train3d_step_ms=ms2_16)
    res["launches"]["spatial_step_gloo"] = {
        k: sum(_counts_from(r["steps"])[k] for r in ranks)
        for k in KERNELS_3D}
    res["launches"]["spatial_train3d_gloo"] = {
        k: sum(r["train3d"]["launches"][k] for r in ranks)
        for k in KERNELS_3D}
    log(f"[phase 24] (d) launches a step a rank {want}, asserted on every "
        f"step of every path; path totals {res['launches']}")
    return res


# -- phase 25: the model axis (channel tensor parallelism, ZeRO-1) ----------

MP_STEPS = 3
MP_TIMEOUT_S = 1200
# kernel launches a step on every rank of the 3D TP path: each rank runs
# every SingleConv's kernel 2 on its out-channel block
MP_3D_LAUNCHES = {"gcr_conv3d": 14, "gn_stats": 14, "gn_affine": 14,
                  "gn_bwd_reduce": 14, "gn_bwd_dx": 13, "overlap_add": 0}
MP_2D_LAUNCHES = 18  # kernel 1's single-conv launches a step: 9 x 2 convs
MP_GRAD_NORM_TOL_2D = 1e-2  # phase 11's bf16 limit


class _collective_bytes:
    """Within: the bytes the model axis's all-gathers return and its
    all-reduces carry (``parallel/tensor.py``), counted."""

    def __enter__(self):
        from mdeical_image_segmentation_tpu_torch.parallel import tensor as tp

        self.tp, self.gather, self.reduce = (tp, tp.all_gather_dim,
                                             tp._all_reduce_model)
        self.bytes = {"gathered": 0, "all_reduced": 0}

        def gather(x, dim, group, size):
            y = self.gather(x, dim, group, size)
            self.bytes["gathered"] += y.numel() * y.element_size()
            return y

        def reduce(g, mesh):
            self.bytes["all_reduced"] += g.numel() * g.element_size()
            return self.reduce(g, mesh)

        tp.all_gather_dim, tp._all_reduce_model = gather, reduce
        return self

    def __exit__(self, *exc):
        self.tp.all_gather_dim, self.tp._all_reduce_model = (self.gather,
                                                             self.reduce)


def _mp_instrument_3d(trainer, rec):
    """``_instrument`` whose step-1 grad norm is the whole model's: the
    sharded gradients' squares summed over the model axis (a collective
    every rank runs at the same step)."""
    import torch

    from mdeical_image_segmentation_tpu_torch.parallel import tensor as tp

    _instrument(trainer, rec)
    step = trainer._train_step

    def whole_norm(input, target, weight):
        out = step(input, target, weight)
        if len(rec) == 1:
            params = [p for p in trainer.model.parameters()
                      if p.grad is not None]
            rec[0]["grad_norm"] = torch.sqrt(tp.grad_norm_squared(
                params, trainer.model).double()).item()
            rec[0].pop("grads", None)
        return out

    trainer._train_step = whole_norm


def _single_conv_count():
    from mdeical_image_segmentation_tpu_torch.ops import fused_conv

    return fused_conv.fused_conv2d_relu.launches


def _mp_train_2d(trainer):
    """3 steps of the 2D trainer: per-step ms, loss, pre-clip grad norm,
    the single-conv and DoubleConv launches of kernel 1."""
    import torch

    from mdeical_image_segmentation_tpu_torch.ops import fused_conv

    rec = []
    step_fn = trainer._train_step

    def step(images, labels):
        torch.cuda.synchronize()
        single, double = _single_conv_count(), (
            fused_conv.fused_double2d.launches)
        t0 = time.perf_counter()
        loss = step_fn(images, labels)
        torch.cuda.synchronize()
        rec.append({"ms": (time.perf_counter() - t0) * 1e3,
                    "loss": loss.item(),
                    "grad_norm": trainer.last_grad_norm.item(),
                    "single": _single_conv_count() - single,
                    "double": fused_conv.fused_double2d.launches - double})
        return loss

    trainer._train_step = step
    trainer.train()
    torch.cuda.synchronize()
    return rec


def _peak_gib():
    import torch

    return torch.cuda.max_memory_allocated() / 2**30


def _steady_ms(rec):
    return statistics.fmean(r["ms"] for r in rec[1:])


def mp_tp_runs(seed: int, out: str, rank: int):
    """(a) and (b) on one rank of a model axis of 2: phase 9's UNet3D and
    phase 11's UNet with ``tensor_parallel``, 3 steps each."""
    import torch

    from mdeical_image_segmentation_tpu_torch.parallel import make_mesh
    from mdeical_image_segmentation_tpu_torch.parallel import tensor as tp

    mesh = make_mesh(n_model=2)
    setup = UNet3DTraining(seed, os.path.join(out, f"setup{rank}"))
    trainer = setup.trainer("tp_3d", max_num_iterations=MP_STEPS - 1,
                            validate_after_iters=1000, log_after_iters=1000,
                            mesh=mesh, tensor_parallel=True)
    shards = {k: tuple(p.shape) for k, p in trainer.model.named_parameters()}
    sharded = tp.sharded_dims(trainer.model)
    rec3 = []
    _mp_instrument_3d(trainer, rec3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _collective_bytes() as moved3:
        _zero_counts()
        trainer.fit()
        torch.cuda.synchronize()
        launches3 = _counts()
    peak3 = _peak_gib()
    state_bytes = sum(p.numel() * p.element_size() * 4  # w, grad, 2 moments
                      for p in trainer.model.parameters())
    del trainer
    torch.cuda.empty_cache()
    u2d = UNet2DTraining(seed, os.path.join(out, f"u2d{rank}"), n_eval=0)
    trainer = u2d.trainer("tp_2d", "bfloat16", mesh=mesh,
                          tensor_parallel=True, max_steps=MP_STEPS,
                          eval_strategy="no", save_steps=0)
    torch.cuda.reset_peak_memory_stats()
    with _collective_bytes() as moved2:
        from mdeical_image_segmentation_tpu_torch.ops import fused_conv

        fused_conv.fused_conv2d_relu.launches = 0
        rec2 = _mp_train_2d(trainer)
        single = fused_conv.fused_conv2d_relu.launches
    peak2 = _peak_gib()
    del trainer
    torch.cuda.empty_cache()
    keep = ("loss", "grad_norm", "ms", "launches")
    return {"3d": {"rec": [{k: r.get(k) for k in keep} for r in rec3],
                   "launches": launches3, "peak_gib": peak3,
                   "state_bytes": state_bytes, "bytes": moved3.bytes,
                   "sharded": len(sharded), "params": len(shards),
                   "block_shapes": shards},
            "2d": {"rec": rec2, "single": single, "peak_gib": peak2,
                   "bytes": moved2.bytes}}


def _moment_bytes(optimizer):
    from mdeical_image_segmentation_tpu_torch.parallel.zero import (
        Zero1Optimizer,
    )

    if isinstance(optimizer, Zero1Optimizer):
        return optimizer.state_bytes()
    return sum(v.numel() * v.element_size()
               for st in optimizer.state.values() for v in st.values()
               if hasattr(v, "numel"))


def mp_zero1_runs(seed: int, out: str, rank: int):
    """(c) on one rank of a data axis of 2: 3 steps of phase 9's UNet3D
    under DDP at a global batch of 2, then with ``zero1``, deterministic
    algorithms; whether the parameters are equal to the bit, the moment
    bytes of each."""
    import torch

    from mdeical_image_segmentation_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    setup = UNet3DTraining(seed, os.path.join(out, f"setup{rank}"))
    setup.batch_size = DP_3D_BATCH
    runs = {}
    with _deterministic():
        for name, zero1 in (("ddp", False), ("zero1", True)):
            t = setup.trainer(name, max_num_iterations=MP_STEPS - 1,
                              validate_after_iters=1000,
                              log_after_iters=1000, mesh=mesh, zero1=zero1)
            rec = []
            _instrument(t, rec)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_counts()
            t.fit()
            torch.cuda.synchronize()
            runs[name] = {
                "rec": [{k: r[k] for k in ("loss", "grad_norm", "ms")}
                        for r in rec],
                "launches": _counts(), "peak_gib": _peak_gib(),
                "moment_bytes": _moment_bytes(t.optimizer),
                "params": [p.detach().clone() for p in t.model.parameters()]}
            del t
            torch.cuda.empty_cache()
    a, b = runs["ddp"].pop("params"), runs["zero1"].pop("params")
    runs["equal"] = all(torch.equal(x, y) for x, y in zip(a, b))
    runs["max_diff"] = max((x - y).abs().max().item() for x, y in zip(a, b))
    return runs


def _whole_state(trainer):
    """The whole parameters (gathered over the model axis) and this rank's
    optimizer state blocks, on the host."""
    from mdeical_image_segmentation_tpu_torch.parallel import tensor as tp

    with tp.full_parameters(trainer.model):
        params = [p.detach().cpu().clone()
                  for p in trainer.model.parameters()]
    opt = trainer.optimizer
    moments = [v.detach().cpu().clone()
               for g in opt.param_groups for s in g["params"]
               for _, v in sorted(opt.state.get(s, {}).items())
               if hasattr(v, "numel")]
    return params, moments


def mp_tp_zero1_runs(seed: int, out: str, rank: int):
    """(d) on one rank of a (2, 2) mesh: phase 9's UNet3D with
    ``tensor_parallel`` and ``zero1`` on an epoch of 4 patches in order at a
    global batch of 2, deterministic algorithms: 3 steps uninterrupted; 2
    steps, the sharded ``DistCheckpointer`` save (every rank its blocks
    into one directory), a trainer resumed from it that takes step 3."""
    import torch

    from mdeical_image_segmentation_tpu_torch.data.loaders import (
        VolumeLoader,
    )
    from mdeical_image_segmentation_tpu_torch.parallel import make_mesh

    mesh = make_mesh(n_model=2)
    setup = UNet3DTraining(seed, os.path.join(out, f"setup{rank}"))
    four = [setup.train_ds[i] for i in range(4)]
    shared = os.path.join(out, "shared")

    def trainer(name, iterations, **kw):
        loaders = {"train": VolumeLoader(four, DP_3D_BATCH),
                   "val": VolumeLoader(setup.val_ds, 1)}
        return _make_trainer(setup.model_cfg, setup.cfg, loaders,
                             os.path.join(shared, name),
                             kw.pop("pre_trained", None), seed=seed,
                             mesh=mesh, max_num_iterations=iterations,
                             validate_after_iters=1000, log_after_iters=1000,
                             tensor_parallel=True, zero1=True, **kw)

    with _deterministic():
        full = trainer("full", MP_STEPS - 1, pre_trained=setup.checkpoint)
        full_rec, _ = _dp_fit_3d(full)
        full_state = _whole_state(full)
        moment_bytes = _moment_bytes(full.optimizer)
        del full
        first = trainer("first", MP_STEPS - 2, pre_trained=setup.checkpoint)
        _dp_fit_3d(first)
        t0 = time.perf_counter()
        first._save_checkpoint(is_best=False)
        save_s = time.perf_counter() - t0
        ckpt_dir = os.path.join(first.checkpoint_dir, "dist_ckpt")
        del first
        t0 = time.perf_counter()
        resumed = trainer("resumed", MP_STEPS - 2, resume=ckpt_dir)
        load_s = time.perf_counter() - t0
        resumed_rec, launches = _dp_fit_3d(resumed)
        resumed_state = _whole_state(resumed)
        del resumed
    torch.cuda.empty_cache()
    unequal = [(("params", "moments")[part], i, tuple(x.shape))
               for part in range(2)
               for i, (x, y) in enumerate(zip(full_state[part],
                                              resumed_state[part]))
               if not torch.equal(x, y)]
    equal = not unequal and all(
        len(full_state[part]) == len(resumed_state[part]) > 0
        for part in range(2))
    files = sorted(f for f in os.listdir(os.path.join(ckpt_dir, "last")))
    return {"full_losses": [r["loss"] for r in full_rec],
            "resumed_losses": [r["loss"] for r in resumed_rec],
            "equal": equal, "unequal": unequal[:4],
            "counts": [len(p) for p in full_state + resumed_state],
            "launches": launches, "save_s": save_s,
            "load_s": load_s, "moment_bytes": moment_bytes, "files": files}


MP_ROLES = {"tp": (mp_tp_runs, 2), "zero1": (mp_zero1_runs, 2),
            "tp_zero1": (mp_tp_zero1_runs, 4)}


def mp_worker(rank: int, world: int, port: int, out: str) -> int:
    """One rank of phase 25: gloo over CUDA tensors on the one card (NCCL
    refuses two ranks on one device); the role is ``out``'s last name;
    writes ``out/rank<rank>.pkl``."""
    import pickle

    import torch

    from mdeical_image_segmentation_tpu_torch.parallel import distributed

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.initialize(f"localhost:{port}", world, rank, backend="gloo")
    try:
        fn, _ = MP_ROLES[os.path.basename(os.path.normpath(out))]
        res = fn(SEED, out, rank)
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def _single_conv_shapes():
    """(N, H, W, Ci, Co) of every single-conv launch of the 2D TP step:
    conv1 and conv2 of the base-64 UNet's 9 DoubleConvs at 256², batch
    32, each with half its out-channels."""
    out = []
    for _, (_, h, w, ci, c1, co) in DC_SHAPES:
        out += [(TRAIN_BATCH_2D, h, w, ci, c1 // 2),
                (TRAIN_BATCH_2D, h, w, c1, co // 2)]
    return out


def phase_tp_kernels(seed: int, train_shapes):
    """(e) kernel 1's single-conv launch against its plain version (F.conv2d
    + bias + relu) at the 18 shapes of the 2D TP step (bf16, N=32, Co/2)
    and against cuDNN's conv2d with the bias (one call); kernel 2 at the
    UNet3D training shapes with Co/2 (fp32, TF32 off) against its plain
    version and cuDNN's conv3d.  Sums of the times and bounds."""
    import torch
    import torch.nn.functional as F

    from mdeical_image_segmentation_tpu_torch.ops import fused_conv

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 25)
    single = {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
              "bound_ms": 0.0, "op_ms": 0.0, "byte_ms": 0.0}
    for shape in _single_conv_shapes():
        n, h, w, ci, co = shape
        x = _rand(gen, (n, h, w, ci), torch.bfloat16)
        wt = _rand(gen, (3, 3, ci, co), torch.bfloat16, (9 * ci) ** -0.5)
        b = _rand(gen, (co,), torch.bfloat16, 0.1)
        err = _compare(f"conv2d_relu {shape}",
                       fused_conv.fused_conv2d_relu(x, wt, b),
                       fused_conv.fused_conv2d_relu_reference(x, wt, b),
                       BF16_TOL)
        xc, wc = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1)
        k_ms, p_ms, l_ms = _time_turns(
            lambda: fused_conv.fused_conv2d_relu(x, wt, b),
            lambda: fused_conv.fused_conv2d_relu_reference(x, wt, b),
            lambda: F.conv2d(xc, wc, b, padding=1))
        flop = 2.0 * 9 * n * h * w * ci * co
        nbytes = 2 * (n * h * w * (ci + co) + 9 * ci * co + co)
        bound, _ = _bound_ms(flop, nbytes, PEAK_BF16)
        for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("library_ms", l_ms),
                       ("bound_ms", bound),
                       ("op_ms", flop / PEAK_BF16 * 1e3),
                       ("byte_ms", nbytes / HBM_BYTES_PER_S * 1e3)):
            single[key] += v
        single["err"] = max(single["err"], err)
        log(f"  conv2d_relu {str(shape):28s} err {err:.2e}; kernel "
            f"{k_ms:8.3f} ms {_rate(flop, k_ms, torch.bfloat16)}; plain "
            f"{p_ms:8.3f} ms; cuDNN conv2d {l_ms:8.3f} ms; bound "
            f"{bound:.3f} ms")
        del x, wt, b, xc, wc
    torch.cuda.empty_cache()
    k2 = {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
          "bound_ms": 0.0, "n": 0}
    for shape, co, model in train_shapes["gcr"]:
        if model != "UNet3D":
            continue
        co //= 2
        ci = shape[-1]
        x = _rand(gen, shape, torch.float32)
        k = _rand(gen, (3, 3, 3, ci, co), torch.float32, (27 * ci) ** -0.5)
        a = torch.rand((shape[0], ci), device=DEVICE, generator=gen) + 0.5
        b = 0.5 * torch.randn((shape[0], ci), device=DEVICE, generator=gen)
        err = _compare(f"gcr_conv3d tp {shape}->{co}",
                       fused_conv.fused_conv3d(x, k, a, b),
                       fused_conv.fused_conv3d_reference(x, k, a, b),
                       FP32_TOL)
        xc, kc = x.permute(0, 4, 1, 2, 3), k.permute(4, 3, 0, 1, 2)
        k_ms, p_ms, l_ms = _time_turns(
            lambda: fused_conv.fused_conv3d(x, k, a, b),
            lambda: fused_conv.fused_conv3d_reference(x, k, a, b),
            lambda: F.conv3d(xc, kc, padding=1))
        flop, nbytes = _gcr_flop_bytes(shape, co, 3, 4)
        bound, _ = _bound_ms(flop, nbytes, PEAK_TF32)
        for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("library_ms", l_ms),
                       ("bound_ms", bound)):
            k2[key] += v
        k2["err"] = max(k2["err"], err)
        k2["n"] += 1
        log(f"  gcr_conv3d tp {str(shape):26s} -> {co:4d}: err {err:.2e}; "
            f"kernel {k_ms:9.3f} ms {_rate(flop, k_ms, torch.float32)}; "
            f"plain {p_ms:9.3f} ms; cuDNN {l_ms:9.3f} ms; bound "
            f"{bound:.3f} ms")
        del x, k, xc, kc
        torch.cuda.empty_cache()
    log(f"[phase 25] (e) kernel 1's single conv over the 18 TP shapes, bf16: "
        f"kernel {single['ms']:.3f} ms, plain {single['plain_ms']:.3f} ms, "
        f"cuDNN conv2d {single['library_ms']:.3f} ms, bound "
        f"{single['bound_ms']:.3f} ms ({_share(single['bound_ms'], single['ms'])}); "
        f"kernel 2 over the {k2['n']} UNet3D training shapes at Co/2, fp32: "
        f"kernel {k2['ms']:.3f} ms, plain {k2['plain_ms']:.3f} ms, cuDNN "
        f"{k2['library_ms']:.3f} ms, bound {k2['bound_ms']:.3f} ms "
        f"({_share(k2['bound_ms'], k2['ms'])})")
    return {"single": single, "k2": k2}


def phase_model_axis(seed: int, workdir: str, train_shapes):
    """Phase 25: (e) the kernels at the TP shapes; the world of 1 (phase
    9's UNet3D and phase 11's UNet, 3 steps each, this process); (a)-(b)
    two ranks on a model axis of 2 with ``tensor_parallel``; (c) two ranks
    on a data axis of 2, DDP against ``zero1``; (d) four ranks on a (2, 2)
    mesh, TP + ZeRO-1, the sharded checkpoint resumed.  Every rank shares
    the one card over gloo.  Returns the numbers and the launches."""
    import torch

    res = {"launches": {}}
    log("[phase 25] (e) kernel 1's single conv and kernel 2 at the "
        "tensor-parallel shapes (Co/2)")
    res["kernels"] = phase_tp_kernels(seed, train_shapes)

    log("[phase 25] the world of 1: phase 9's UNet3D and phase 11's UNet, "
        f"{MP_STEPS} steps each")
    setup = UNet3DTraining(seed, os.path.join(workdir, "mp_ref"))
    t = setup.trainer("ref_3d", max_num_iterations=MP_STEPS - 1,
                      validate_after_iters=1000, log_after_iters=1000)
    ref3 = []
    _instrument(t, ref3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t.fit()
    torch.cuda.synchronize()
    ref3_peak = _peak_gib()
    del t
    torch.cuda.empty_cache()
    u2d = UNet2DTraining(seed, os.path.join(workdir, "mp_ref2d"), n_eval=0)
    t = u2d.trainer("ref_2d", "bfloat16", max_steps=MP_STEPS,
                    eval_strategy="no", save_steps=0)
    torch.cuda.reset_peak_memory_stats()
    ref2 = _mp_train_2d(t)
    ref2_peak = _peak_gib()
    del t
    torch.cuda.empty_cache()

    log("[phase 25] (a)-(b) two ranks on a model axis of 2, "
        "tensor_parallel, gloo on the one card")
    t0 = time.perf_counter()
    ranks = _dp_ranks(os.path.join(workdir, "tp"), 2, "--mp-worker",
                      MP_TIMEOUT_S)
    res["tp_wall_s"] = time.perf_counter() - t0
    for rank, r in enumerate(ranks):
        d3 = r["3d"]
        for i, step in enumerate(d3["rec"]):
            if step["launches"] != MP_3D_LAUNCHES:
                raise AssertionError(f"(a) rank {rank} step {i + 1} "
                                     f"launches {step['launches']}, want "
                                     f"{MP_3D_LAUNCHES}")
        for i, step in enumerate(r["2d"]["rec"]):
            if step["single"] != MP_2D_LAUNCHES or step["double"] != 0:
                raise AssertionError(f"(b) rank {rank} step {i + 1}: "
                                     f"{step['single']} single-conv and "
                                     f"{step['double']} DoubleConv launches,"
                                     f" want {MP_2D_LAUNCHES} and 0")
        if d3["sharded"] == 0 or d3["sharded"] >= d3["params"]:
            raise AssertionError(f"(a) {d3['sharded']} of {d3['params']} "
                                 "parameters sharded")
    if ([s["loss"] for s in ranks[0]["3d"]["rec"]]
            != [s["loss"] for s in ranks[1]["3d"]["rec"]]):
        raise AssertionError("(a) the model ranks' losses differ")
    _dp_gaps("(a) 3D TP, 2 ranks vs 1", ranks[0]["3d"]["rec"], ref3)
    _dp_gaps("(b) 2D TP, 2 ranks vs 1", ranks[0]["2d"]["rec"], ref2,
             BF16_LOSS_TOLS, MP_GRAD_NORM_TOL_2D)
    res["tp_3d"] = {
        "step_ms": [_steady_ms(r["3d"]["rec"]) for r in ranks],
        "ref_step_ms": _steady_ms(ref3),
        "peak_gib": [r["3d"]["peak_gib"] for r in ranks],
        "ref_peak_gib": ref3_peak,
        "state_bytes_per_rank": ranks[0]["3d"]["state_bytes"],
        "bytes_per_rank_3_steps": ranks[0]["3d"]["bytes"],
        "losses": [s["loss"] for s in ranks[0]["3d"]["rec"]],
        "ref_losses": [s["loss"] for s in ref3[:MP_STEPS]]}
    res["tp_2d"] = {
        "step_ms": [_steady_ms(r["2d"]["rec"]) for r in ranks],
        "ref_step_ms": _steady_ms(ref2),
        "peak_gib": [r["2d"]["peak_gib"] for r in ranks],
        "ref_peak_gib": ref2_peak,
        "bytes_per_rank_3_steps": ranks[0]["2d"]["bytes"],
        "losses": [s["loss"] for s in ranks[0]["2d"]["rec"]],
        "ref_losses": [s["loss"] for s in ref2]}
    res["launches"]["tp_3d"] = {k: sum(r["3d"]["launches"][k] for r in ranks)
                                for k in KERNELS_3D}
    res["single_conv_launches"] = sum(r["2d"]["single"] for r in ranks)
    log(f"  (a) step {res['tp_3d']['step_ms']} ms a rank against "
        f"{res['tp_3d']['ref_step_ms']:.1f} ms alone; peak "
        f"{res['tp_3d']['peak_gib']} GiB a rank against "
        f"{ref3_peak:.2f} GiB; moved a rank in 3 steps "
        f"{res['tp_3d']['bytes_per_rank_3_steps']}")
    log(f"  (b) step {res['tp_2d']['step_ms']} ms a rank against "
        f"{res['tp_2d']['ref_step_ms']:.1f} ms alone; peak "
        f"{res['tp_2d']['peak_gib']} GiB a rank against "
        f"{ref2_peak:.2f} GiB; moved a rank in 3 steps "
        f"{res['tp_2d']['bytes_per_rank_3_steps']}")

    log("[phase 25] (c) two ranks on a data axis of 2: DDP against zero1, "
        "deterministic algorithms")
    ranks = _dp_ranks(os.path.join(workdir, "zero1"), 2, "--mp-worker",
                      MP_TIMEOUT_S)
    for rank, r in enumerate(ranks):
        log(f"  rank {rank}: parameters equal to the bit {r['equal']} (max "
            f"diff {r['max_diff']:.3e}); moment bytes DDP "
            f"{r['ddp']['moment_bytes']}, zero1 {r['zero1']['moment_bytes']};"
            f" step ms DDP {_steady_ms(r['ddp']['rec']):.1f}, zero1 "
            f"{_steady_ms(r['zero1']['rec']):.1f}; peak GiB "
            f"{r['ddp']['peak_gib']:.2f} / {r['zero1']['peak_gib']:.2f}")
        if not r["equal"]:
            raise AssertionError("(c) zero1's parameters differ from DDP's")
        if r["zero1"]["moment_bytes"] * 1.9 > r["ddp"]["moment_bytes"]:
            raise AssertionError("(c) zero1 did not halve the moments")
    res["zero1_3d"] = {
        "moment_bytes": [r["zero1"]["moment_bytes"] for r in ranks],
        "ddp_moment_bytes": [r["ddp"]["moment_bytes"] for r in ranks],
        "step_ms": [_steady_ms(r["zero1"]["rec"]) for r in ranks],
        "ddp_step_ms": [_steady_ms(r["ddp"]["rec"]) for r in ranks],
        "peak_gib": [r["zero1"]["peak_gib"] for r in ranks],
        "ddp_peak_gib": [r["ddp"]["peak_gib"] for r in ranks]}
    res["launches"]["zero1_3d"] = {k: sum(r["zero1"]["launches"][k]
                                          for r in ranks)
                                   for k in KERNELS_3D}

    log("[phase 25] (d) four ranks on a (2, 2) mesh: TP + ZeRO-1, the "
        "sharded checkpoint resumed")
    ranks = _dp_ranks(os.path.join(workdir, "tp_zero1"), 4, "--mp-worker",
                      MP_TIMEOUT_S)
    for rank, r in enumerate(ranks):
        log(f"  rank {rank}: losses {r['full_losses']} uninterrupted, "
            f"resumed step 3 {r['resumed_losses']}; state equal to the bit "
            f"{r['equal']} (unequal {r['unequal']}, tensors {r['counts']}); save {r['save_s']:.2f} s, resume "
            f"{r['load_s']:.2f} s; moment bytes {r['moment_bytes']}; "
            f"files {r['files']}")
        if (not r["equal"] or r["resumed_losses"] != r["full_losses"][2:]):
            raise AssertionError("(d) the resumed step 3 differs from the "
                                 "uninterrupted one")
    res["tp_zero1_3d"] = {"moment_bytes": [r["moment_bytes"] for r in ranks],
                          "save_s": ranks[0]["save_s"],
                          "load_s": ranks[0]["load_s"]}
    res["launches"]["tp_zero1_resume"] = {
        k: sum(r["launches"][k] for r in ranks) for k in KERNELS_3D}
    return res


# ---------------------------------------------------------------------------
# Phase 26: the files the JAX package reads through h5py, PIL and imageio:
# libver='latest' HDF5 (superblock 3, v2 object headers, layout 4's chunk
# indexes, LZF / Fletcher-32 / scale-offset, bool and float16, link groups),
# the "r+" memo appended to such a file, and palette, sub-byte, 16-bit
# colour and interlaced PNGs
# ---------------------------------------------------------------------------

FIXTURES = os.path.join(ROOT, "tests", "fixtures")
PHANTOM = os.path.join(FIXTURES, "h5_latest", "phantom_latest.h5")
READ_REPEATS = 3  # the phantom's read: best of 3, latest file and v0 copy


def fixture_entry(a) -> dict:
    """Shape, dtype and SHA-256 of the C-order bytes (a bool array's as 0
    and 1), as ``scripts/make_port_fixtures.py`` wrote the manifest."""
    import hashlib

    import numpy as np

    a = np.asarray(a)  # a 0-d array keeps its shape
    raw = np.ascontiguousarray(a).tobytes()
    if a.dtype == bool:
        raw = (np.frombuffer(raw, np.uint8) != 0).tobytes()
    return {"shape": list(a.shape), "dtype": a.dtype.str,
            "sha256": hashlib.sha256(raw).hexdigest()}


def _check_fixtures(jpeg: bool = False) -> dict:
    """(a) every committed HDF5 fixture, PNG, TIFF, GIF and BMP (with
    ``jpeg``: every JPEG alone) read by the port against the manifest h5py,
    imageio and PIL gave: each dataset, each group's keys(), each image as
    ``image.imread`` (the DSB reader) and ``image.read`` give it (an image
    PIL does not open must raise)."""
    from mdeical_image_segmentation_tpu_torch.utils import hdf5, image

    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    manifest["image_formats"] = {
        k: v for k, v in manifest["image_formats"].items()
        if k.endswith(".jpg") == jpeg}
    if jpeg:
        manifest["h5_latest"], manifest["png_extra"] = {}, {}
    n_ds = _check_h5_files(manifest["h5_latest"],
                           os.path.join(FIXTURES, "h5_latest"))
    for group in ("png_extra", "image_formats"):
        for name, want in sorted(manifest[group].items()):
            path = os.path.join(FIXTURES, group, name)
            got = {"imageio": fixture_entry(image.imread(path))}
            for mode in ("L", "RGB"):
                try:
                    got[f"pil_{mode}"] = fixture_entry(image.read(path, mode))
                except image.ImageError:
                    got[f"pil_{mode}"] = None
            want = {k: v for k, v in want.items() if k != "note"}
            if got != want:
                raise AssertionError(f"{name} decodes as {got}, the manifest "
                                     f"holds {want}")
    return {"h5_files": len(manifest["h5_latest"]), "datasets": n_ds,
            "pngs": len(manifest["png_extra"]),
            "images": len(manifest["image_formats"])}


def _check_h5_files(manifest: dict, directory: str) -> int:
    """Each HDF5 file of ``manifest`` (a section of ``manifest.json``) in
    ``directory`` read by the port: each group's keys() and each dataset's
    shape, dtype and SHA-256 as h5py gave them; the datasets checked."""
    from mdeical_image_segmentation_tpu_torch.utils import hdf5

    n_ds = 0
    for name, want in sorted(manifest.items()):
        with hdf5.File(os.path.join(directory, name)) as f:
            for group, keys in want["groups"].items():
                if f[group].keys() != keys:
                    raise AssertionError(f"{name}:{group} keys "
                                         f"{f[group].keys()}, want {keys}")
            for ds, entry in want["datasets"].items():
                got = fixture_entry(f[ds][()])
                if got != entry:
                    raise AssertionError(f"{name}:{ds} reads as {got}, the "
                                         f"manifest holds {entry}")
                n_ds += 1
    return n_ds


def _best_read_s(path: str, repeats: int = READ_REPEATS) -> float:
    from mdeical_image_segmentation_tpu_torch.utils import hdf5

    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        with hdf5.File(path) as f:
            f["raw"][:]
        best = min(best, time.perf_counter() - t0)
    return best


def _predict_phantom(path: str, ckpt: str, out_dir: str, lazy: bool):
    """cli/predict3d.py on configs/unet3d_predict.yml over ``path`` (Standard
    or Lazy); the map, the launches, the batches and the wall time."""
    import torch

    from mdeical_image_segmentation_tpu_torch.cli import predict3d
    from mdeical_image_segmentation_tpu_torch.infer import (
        predictor as predictor_lib,
    )
    from mdeical_image_segmentation_tpu_torch.utils import hdf5

    argv = ["--config", PREDICT_YML, "--model_path", ckpt,
            "--output_dir", out_dir, "--loaders.test.file_paths",
            repr([path])]
    if lazy:
        argv += ["--loaders.dataset", "LazyHDF5Dataset",
                 "--predictor.name", "LazyPredictor"]
    rec = []
    get = predictor_lib.get_predictor

    def instrumented(model, output_dir, config, **kw):
        p = get(model, output_dir, config, **kw)
        _timed_batches(p, rec)
        return p

    predictor_lib.get_predictor = instrumented
    try:
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        (written,) = predict3d.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts()
    finally:
        predictor_lib.get_predictor = get
    for i, (_, n) in enumerate(rec):
        if n["gcr_conv3d"] != 14 or n["gn_stats"] != 14:
            raise AssertionError(f"{path}, batch {i}: {n}, want 14 "
                                 "gcr_conv3d and 14 gn_stats launches")
    want_overlap = 0 if lazy else len(rec)
    if len(rec) != 1 or launches["overlap_add"] != want_overlap:
        raise AssertionError(f"{path}: {launches} over {len(rec)} batches, "
                             f"want one batch of 4 and {want_overlap} "
                             "overlap_add")
    with hdf5.File(written) as f:
        got = f["predictions"][:]
    return {"map": got, "launches": launches, "wall_s": wall,
            "batch_ms": rec[0][0]}


def _dsb_new_pngs(seed: int, workdir: str) -> dict:
    """(d) cli/predict3d.py with DSB2018Dataset and DSB2018Predictor over
    each of the PNG fixtures' directories (1, 3 and 4 channels as imageio
    reads them), a seeded UNet2D of that many input channels each."""
    import numpy as np
    import torch

    from mdeical_image_segmentation_tpu_torch.cli import predict3d
    from mdeical_image_segmentation_tpu_torch.utils import hdf5, yaml_io

    pred_cfg = read_yaml_subset(PREDICT_YML)
    total = {k: 0 for k in KERNELS_3D}
    images = 0
    for ch in (1, 3, 4):
        root = os.path.join(FIXTURES, "png_extra", f"dsb_c{ch}")
        n = len(os.listdir(os.path.join(root, "images")))
        model = dict(DSB_MODEL, in_channels=ch)
        cfg = {"model": model,
               "model_path": _initial_checkpoint(model, seed + ch, workdir,
                                                 f"dsb_c{ch}"),
               "output_dir": os.path.join(workdir, f"dsb_c{ch}_out"),
               "predictor": {"name": "DSB2018Predictor"},
               "loaders": {"dataset": "DSB2018Dataset",
                           "batch_size": DSB_BATCH,
                           "test": {"file_paths": [root], "transformer":
                                    pred_cfg["loaders"]["test"]["transformer"]}}}
        os.makedirs(cfg["output_dir"])
        cfg_path = os.path.join(workdir, f"dsb_c{ch}.yml")
        with open(cfg_path, "w") as f:
            f.write(yaml_io.dumps(cfg))
        torch.cuda.synchronize()
        _zero_counts()
        (files,) = predict3d.main(["--config", cfg_path])
        torch.cuda.synchronize()
        launches = _counts()
        per_batch = 2 * (2 * DSB_MODEL["num_levels"] - 1)
        batches = -(-n // DSB_BATCH)
        if (len(files) != n or launches["gn_stats"] != per_batch * batches
                or launches["gn_affine"] != per_batch * batches):
            raise AssertionError(f"dsb_c{ch}: {launches} for {len(files)} "
                                 f"files, want {per_batch * batches} "
                                 f"GroupNorm launches for {n}")
        for path in files:
            with hdf5.File(path) as f:
                p, seg = f["predictions"][:], f["segmentation"][:]
            if (p.shape != (32, 48) or not np.isfinite(p).all()
                    or seg.dtype != np.uint16):
                raise AssertionError(f"{path}: predictions {p.shape}, "
                                     f"segmentation {seg.dtype}")
        for k in KERNELS_3D:
            total[k] += launches[k]
        images += n
    return {"images": images, "launches": total}


def phase_read_formats(seed: int, workdir: str) -> dict:
    """Phase 26: (a) the fixtures against their manifest; (b) predict3d
    (Standard) over the libver='latest' phantom and over its copy in the
    port's own superblock-0 writer, to the bit; (c) LazyPredictor on a copy
    of the latest file, the memo appended with "r+" and read back; (d)
    DSB2018 over the new PNGs."""
    import numpy as np

    from mdeical_image_segmentation_tpu_torch.data.volume_utils import (
        mirror_pad,
    )
    from mdeical_image_segmentation_tpu_torch.utils import hdf5

    workdir = os.path.join(workdir, "phase26")
    os.makedirs(workdir)
    t0 = time.perf_counter()
    fixtures = _check_fixtures()
    fixtures["s"] = time.perf_counter() - t0
    log(f"[phase 26] (a) {fixtures['datasets']} datasets of "
        f"{fixtures['h5_files']} HDF5 fixtures, {fixtures['pngs']} PNGs and "
        f"{fixtures['images']} TIFF, GIF and BMP files equal to the manifest "
        f"in {fixtures['s']:.2f} s")

    # (b) the latest file and its v0 copy through the same command
    latest = os.path.join(workdir, "phantom_latest.h5")
    shutil.copy(PHANTOM, latest)
    with hdf5.File(latest) as f:
        raw = f["raw"][:]
        index = f["raw"]._index_type
    v0 = os.path.join(workdir, "phantom_v0.h5")
    write_h5_volume(v0, raw)
    reads = {"latest_s": _best_read_s(latest), "v0_s": _best_read_s(v0)}
    log(f"[phase 26] (b) the {raw.shape} {raw.dtype} phantom read whole by "
        f"the port (best of {READ_REPEATS}, warm): latest file (chunk index "
        f"type {index}, shuffle + gzip) {reads['latest_s']:.3f} s, its v0 "
        f"copy (v1 B-tree, gzip) {reads['v0_s']:.3f} s")
    cfg = read_yaml_subset(PREDICT_YML)
    ckpt = _initial_checkpoint(cfg["model"], seed, workdir, "phantom_unet3d")
    std = {tag: _predict_phantom(path, ckpt, os.path.join(workdir, tag),
                                 lazy=False)
           for tag, path in (("latest", latest), ("v0", v0))}
    a, b = std["latest"]["map"], std["v0"]["map"]
    if a.shape != (1,) + raw.shape or not np.isfinite(a).all() or not (
            np.array_equal(a, b)):
        raise AssertionError(f"the latest file's map {a.shape} differs from "
                             "the v0 copy's")
    log("[phase 26] (b) predict3d (StandardPredictor): latest "
        f"{std['latest']['wall_s']:.2f} s, v0 copy {std['v0']['wall_s']:.2f}"
        f" s; batch {std['latest']['batch_ms']:.1f} / "
        f"{std['v0']['batch_ms']:.1f} ms; maps equal to the bit; launches "
        f"{std['latest']['launches']} each")

    # (c) LazyPredictor appends the memo to a copy of the latest file
    lazy_path = os.path.join(workdir, "phantom_lazy.h5")
    shutil.copy(PHANTOM, lazy_path)
    halo = cfg["loaders"]["test"]["slice_builder"]["halo_shape"]
    memo = "raw_padded_" + "x".join(str(h) for h in halo)
    with hdf5.File(lazy_path) as f:
        root_before = f._header_addr
    scale = max(1.0, float(np.abs(a).max()))
    lazy, launches = {}, {k: 0 for k in KERNELS_3D}
    for run in ("memo written", "memo read"):
        size = os.path.getsize(lazy_path)
        lazy[run] = _predict_phantom(lazy_path, ckpt, os.path.join(
            workdir, f"lazy_{len(lazy)}"), lazy=True)
        err = float(np.abs(lazy[run]["map"] - a).max())
        if err > LAZY_MAP_TOL * scale:
            raise AssertionError(f"lazy {run}: the map differs from (b)'s by "
                                 f"{err:.3e} (limit {LAZY_MAP_TOL} x "
                                 f"{scale:.3f})")
        lazy[run]["err"] = err
        for k in KERNELS_3D:
            launches[k] += lazy[run]["launches"][k]
        with hdf5.File(lazy_path) as f:
            keys = f.keys()
            sb, root = f._store.sb_version, f._header_addr
            eof = struct.unpack("<Q", f._store.read(f._eof_field, 8))[0]
            got_memo = f[memo][:]
        if (keys != ["raw", memo] or sb != 3 or root == root_before
                or eof != os.path.getsize(lazy_path)
                or not np.array_equal(got_memo, mirror_pad(raw, halo))):
            raise AssertionError(f"lazy {run}: {lazy_path} holds {keys}, "
                                 f"superblock {sb}, root header {root} "
                                 f"(was {root_before}), end of file {eof} of "
                                 f"{os.path.getsize(lazy_path)} bytes")
        if run == "memo read" and os.path.getsize(lazy_path) != size:
            raise AssertionError("the second Lazy run wrote to the file")
        log(f"[phase 26] (c) LazyPredictor, {run}: "
            f"{lazy[run]['wall_s']:.2f} s, map vs (b) max |diff| {err:.3e}; "
            f"the file holds {keys} under superblock {sb}, its root header "
            f"rewritten at {root} (was {root_before}), end of file patched "
            f"to {eof}")

    # (d) DSB over the new PNGs
    t0 = time.perf_counter()
    dsb = _dsb_new_pngs(seed, workdir)
    dsb["wall_s"] = time.perf_counter() - t0
    log(f"[phase 26] (d) DSB2018Predictor over {dsb['images']} palette, "
        f"sub-byte, 16-bit colour and interlaced PNGs in "
        f"{dsb['wall_s']:.2f} s; launches {dsb['launches']}")
    for r in list(std.values()) + list(lazy.values()):
        r.pop("map")
    return {"fixtures": fixtures, "reads": reads, "standard": std,
            "lazy": lazy, "dsb": dsb,
            "launches": {"latest_predict3d": std["latest"]["launches"],
                         "latest_v0_predict3d": std["v0"]["launches"],
                         "latest_lazy": launches,
                         "dsb_png_extra": dsb["launches"]}}


# ---------------------------------------------------------------------------
# 27. TIFF, GIF and BMP: DRIVE's published formats through serving, the 2D
# trainer and DSB2018
# ---------------------------------------------------------------------------

IMAGE_FIXTURES = os.path.join(FIXTURES, "image_formats")
DRIVE_RES = 512          # the reference's resolution (data/png2d.py)
DRIVE_BATCH = 4
DRIVE_STEPS = 3
DRIVE_PAIRS = 20         # DRIVE's training set: a 13 / 4 / 3 split
DECODE_REPEATS = 5       # decode ms: median of 5, warm


def fixture_script():
    """``scripts/make_port_fixtures.py`` as a module: its encoders and its
    seeded synthetic retina (numpy, struct and zlib; PIL, imageio and h5py
    only inside the functions that write the committed fixtures)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_port_fixtures", os.path.join(ROOT, "scripts",
                                           "make_port_fixtures.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _pil_luma(rgb):
    """PIL's convert("L") of RGB uint8."""
    import numpy as np

    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(
        np.uint8)


def drive_sized_files(workdir: str) -> dict:
    """The DRIVE-sized (565x584) files of (b) and (c): the committed LZW +
    predictor-2 and deflate + predictor-2 TIFFs and the two GIF masks, and
    uncompressed, PackBits and 16-bit grey TIFFs and 24-bit, 8-bit palette
    and RLE8 BMPs written here.  {format: (path, {"L": pixels, "RGB":
    pixels})}, the pixels PIL's ``convert`` gives, computed from the arrays
    each file was written from (never from the port's decoders)."""
    import numpy as np

    fx = fixture_script()
    rgb, vessels, fov = fx.retina()
    flipped = np.ascontiguousarray(rgb[:, ::-1])
    rolled = np.ascontiguousarray(np.roll(rgb, 97, axis=1))
    upside = np.ascontiguousarray(rgb[::-1])
    g16 = _pil_luma(rgb).astype(np.uint16) * 3 + 11
    rng = np.random.default_rng(SEED + 27)
    pal = rng.integers(0, 256, (64, 3), dtype=np.uint8)
    idx = (rgb[..., 0] // 64) * 16 + (rgb[..., 1] // 64) * 4 + rgb[..., 2] // 64
    pal4 = rng.integers(0, 256, (4, 3), dtype=np.uint8)
    idx4 = vessels // 255 + (fov // 255) * 2

    def both(rgb_px):
        return {"L": _pil_luma(rgb_px), "RGB": rgb_px}

    def grey(g):
        g8 = np.minimum(g, 255).astype(np.uint8)
        return {"L": g8, "RGB": np.repeat(g8[..., None], 3, axis=-1)}

    d = os.path.join(workdir, "drive_sized")
    os.makedirs(d)
    written = {
        "tiff_raw": ("raw.tif", fx.encode_tiff([fx.tiff_page(
            rolled, 8, 2, rowsperstrip=16)]), both(rolled)),
        "tiff_packbits": ("packbits.tif", fx.encode_tiff([fx.tiff_page(
            upside, 8, 2, 32773, rowsperstrip=16)]), both(upside)),
        "tiff_grey16": ("grey16.tif", fx.encode_tiff([fx.tiff_page(
            g16[..., None], 16, 1, 8, 2)]), grey(g16)),
        "bmp_24": ("rgb24.bmp", fx.encode_bmp(rgb, 24), both(rgb)),
        "bmp_pal8": ("pal8.bmp", fx.encode_bmp(idx, 8, pal), both(pal[idx])),
        "bmp_rle8": ("rle8.bmp", fx.encode_bmp(idx4, 8, pal4, compression=1),
                     both(pal4[idx4])),
    }
    files = {
        "tiff_lzw_pred2": (os.path.join(IMAGE_FIXTURES, "drive",
                                        "21_training.tif"), both(rgb)),
        "tiff_deflate_pred2": (os.path.join(IMAGE_FIXTURES, "drive",
                                            "22_training.tif"),
                               both(flipped)),
        "gif_manual": (os.path.join(IMAGE_FIXTURES, "drive",
                                    "21_manual1.gif"), grey(vessels)),
        "gif_fov": (os.path.join(IMAGE_FIXTURES, "drive",
                                 "21_training_mask.gif"), grey(fov)),
    }
    for fmt, (name, data, px) in written.items():
        path = os.path.join(d, name)
        with open(path, "wb") as f:
            f.write(data)
        files[fmt] = (path, px)
    return files


def _decode_ms(path: str, mode: str) -> float:
    from mdeical_image_segmentation_tpu_torch.utils import image

    times = []
    for _ in range(DECODE_REPEATS):
        t0 = time.perf_counter()
        image.read(path, mode)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _formats_serve(seed: int, workdir: str, files: dict,
                   tag: str = "27") -> dict:
    """(b) phase 2's base-64 bf16 UNet at 256² ("unet", convert "L") and its
    3-channel twin ("drive", convert "RGB") behind one SegmentationServer;
    8 clients POST every DRIVE-sized file to both and the PNG of the same
    pixels beside it."""
    import numpy as np

    from mdeical_image_segmentation_tpu_torch.ops.fused_conv import (
        fused_double2d,
    )
    from mdeical_image_segmentation_tpu_torch.serve import (
        ModelRegistry,
        SegmentationServer,
    )
    from mdeical_image_segmentation_tpu_torch.utils import image, png

    res, max_batch, clients = 256, 8, 8
    registry = ModelRegistry()
    t0 = time.time()
    for name, ch in (("unet", 1), ("drive", 3)):
        registry.register_unet2d(name, unet2d_bundle(seed, workdir, ch),
                                 resolution=res, device="cuda",
                                 max_batch=max_batch)
    log(f"[phase {tag}] (b) registered the 1- and 3-channel UNets (load + "
        f"warm-up) in {time.time() - t0:.2f} s")
    requests, decode = [], {}
    for fmt, (path, pixels) in sorted(files.items()):
        for model, mode in (("unet", "L"), ("drive", "RGB")):
            got = image.read(path, mode)
            if not np.array_equal(got, pixels[mode]):
                raise AssertionError(f"{fmt}: convert({mode!r}) differs from "
                                     "the pixels it was written from")
            twin = os.path.join(workdir, f"twin_{fmt}_{mode}.png")
            png.write(twin, pixels[mode])
            requests += [(fmt, model, path), (fmt, model, twin)]
            decode[f"{fmt} {mode}"] = {"ms": _decode_ms(path, mode),
                                       "png_twin_ms": _decode_ms(twin, mode)}
    srv = SegmentationServer(registry,
                             output_dir=os.path.join(workdir,
                                                     f"masks{tag}"),
                             max_batch=max_batch, max_wait_ms=5.0)
    port = srv.start(host="127.0.0.1", port=0).server_address[1]
    replies = [None] * len(requests)
    try:
        occ = srv.engine.occupancy()
        before = sum(occ.get(m, {"batches": 0})["batches"]
                     for m in ("unet", "drive"))
        fused_double2d.launches = 0

        def client(k):
            for i in range(k, len(requests), clients):
                _, model, path = requests[i]
                replies[i] = _post(port, {"image_path": path, "model": model,
                                          "return": "mask"})

        t0 = time.time()
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.time() - t0
        launches = fused_double2d.launches
        if any(t.is_alive() for t in threads):
            raise AssertionError("a client did not finish within 600 s")
        stats = _get(port, "/stats")
        occ = srv.engine.occupancy()
    finally:
        srv.stop()
    batches = sum(occ[m]["batches"] for m in ("unet", "drive")) - before
    masks = []
    for i, (status, body) in enumerate(replies):
        fmt, model, path = requests[i]
        if status != 200 or body.get("status") != 200:
            raise AssertionError(f"{fmt} to {model} ({path}): {status} "
                                 f"{body}")
        mask = np.asarray(body["response"], np.uint8)
        if mask.shape != (res, res):
            raise AssertionError(f"{fmt} to {model}: mask {mask.shape}")
        masks.append(mask)
    for i in range(0, len(requests), 2):
        if not np.array_equal(masks[i], masks[i + 1]):
            fmt, model, _ = requests[i]
            raise AssertionError(f"{fmt} to {model}: its mask differs from "
                                 "its PNG twin's")
    if batches <= 0 or launches != 18 * batches:
        raise AssertionError(f"{launches} kernel-1 launches for {batches} "
                             "device batches (want 18 per batch)")
    log(f"[phase {tag}] (b) {len(requests)} requests ({len(files)} formats x 2 "
        f"models x file and PNG twin) from {clients} clients in {wall:.3f} s:"
        f" all 200, every mask equal to its twin's; {launches} kernel-1 "
        f"launches for {batches} device batches; p50 {stats['p50_ms']} ms, "
        f"p99 {stats['p99_ms']} ms")
    log(f"[phase {tag}] (b) decode ms at 565x584 (image.read, median of "
        f"{DECODE_REPEATS}, warm): " + "; ".join(
            f"{k} {v['ms']:.2f} (PNG {v['png_twin_ms']:.2f})"
            for k, v in sorted(decode.items())))
    return {"launches": launches, "batches": batches, "wall_s": wall,
            "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
            "decode_ms": decode}


DRIVE_TIFFS = ("tiff_lzw_pred2", "tiff_deflate_pred2", "tiff_raw",
               "tiff_packbits")


def _drive_layout(root: str, files: dict, png_copy: bool,
                  images=DRIVE_TIFFS, label: str = "gif_manual"):
    """``DRIVE_PAIRS`` pairs of images/NN_training.<ext> and
    labels/NN_manual1.<ext> copied from the ``images`` files in turn and the
    ``label`` file, or (``png_copy``) PNGs of the same pixels."""
    from mdeical_image_segmentation_tpu_torch.utils import png

    for sub in ("images", "labels"):
        os.makedirs(os.path.join(root, sub))
    for i in range(DRIVE_PAIRS):
        n = 21 + i
        src, px = files[images[i % len(images)]]
        lsrc, lpx = files[label]
        if png_copy:
            png.write(os.path.join(root, "images", f"{n}_training.png"),
                      px["RGB"])
            png.write(os.path.join(root, "labels", f"{n}_manual1.png"),
                      lpx["L"])
        else:
            shutil.copy(src, os.path.join(
                root, "images", f"{n}_training{os.path.splitext(src)[1]}"))
            shutil.copy(lsrc, os.path.join(
                root, "labels", f"{n}_manual1{os.path.splitext(lsrc)[1]}"))


def _train2d_cli(root: str, out: str, seed: int):
    """cli/train2d.py on the DRIVE layout at ``root``: the base-64 bf16 UNet
    at 512², batch 4, 3 steps, then its final evaluation; the steps'
    records, the eval batches' launches and the run's kernel-1 launches."""
    import torch

    from mdeical_image_segmentation_tpu_torch.cli import train2d
    from mdeical_image_segmentation_tpu_torch.ops import fused_conv
    from mdeical_image_segmentation_tpu_torch.train import Trainer

    rec, evals = [], []
    init = Trainer.__init__

    def instrumented(self, *a, **kw):
        init(self, *a, **kw)
        _instrument_2d(self, rec, evals)

    argv = ["--dataset", "DRIVE", "--data_path", root, "--output_dir", out,
            "--unet_type", "UNet", "--base_features", "64",
            "--in_channels", "3", "--resolution", str(DRIVE_RES), "--bf16",
            "--per_device_train_batch_size", str(DRIVE_BATCH),
            "--per_device_eval_batch_size", str(DRIVE_BATCH),
            "--max_steps", str(DRIVE_STEPS), "--eval_strategy", "no",
            "--save_steps", "0", "--logging_steps", "1", "--seed", str(seed)]
    Trainer.__init__ = instrumented
    try:
        torch.cuda.synchronize()
        fused_conv.fused_double2d.launches = 0
        t0 = time.perf_counter()
        train2d.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        Trainer.__init__ = init
    return rec, evals, fused_conv.fused_double2d.launches, wall


def _drive_train(seed: int, workdir: str, files: dict, tag: str = "27",
                 images=DRIVE_TIFFS, label: str = "gif_manual",
                 what: str = "TIFF + GIF") -> dict:
    """(c) a DRIVE directory of the ``images`` files and the ``label``
    manual (TIFF images and GIF manuals, or JPEGs): the split, every item
    against a PNG copy's, cli/train2d.py on the kernel path and on the
    plain path from the same weights and batches."""
    import numpy as np

    from mdeical_image_segmentation_tpu_torch.data import DRIVEDataset

    root, png_root = (os.path.join(workdir, "DRIVE"),
                      os.path.join(workdir, "DRIVE_png"))
    _drive_layout(root, files, False, images, label)
    _drive_layout(png_root, files, True, images, label)
    sizes, t0 = {}, time.perf_counter()
    for mode in ("train", "eval", "test"):
        ours = DRIVEDataset(root, mode, resolution=DRIVE_RES)
        twin = DRIVEDataset(png_root, mode, resolution=DRIVE_RES)
        sizes[mode] = len(ours)
        for i in range(len(ours)):
            a, b = ours[i], twin[i]
            for k in ("image", "mask"):
                if a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k]):
                    raise AssertionError(f"DRIVE {mode} item {i} {k}: the "
                                         f"{what} item differs from the "
                                         "PNG copy's")
    items_s = time.perf_counter() - t0
    if sizes != {"train": 13, "eval": 4, "test": 3}:
        raise AssertionError(f"DRIVE split {sizes}, want 13 / 4 / 3")
    log(f"[phase {tag}] (c) DRIVE layout of {DRIVE_PAIRS} {what} pairs: "
        f"split {sizes}; every item at {DRIVE_RES}² equal to the PNG "
        f"copy's ({items_s:.2f} s for both, decode and resize)")
    rec, evals, launches, wall = _train2d_cli(
        root, os.path.join(workdir, "drive_run"), seed)
    with plain_path():
        p_rec, _, _, p_wall = _train2d_cli(
            root, os.path.join(workdir, "drive_plain"), seed)
    bad = [i + 1 for i, r in enumerate(rec)
           if r["launches"] != 18 or not np.isfinite(r["loss"])]
    if (bad or len(rec) != DRIVE_STEPS or not evals
            or any(n != 18 for n in evals)
            or launches != 18 * (len(rec) + len(evals))):
        raise AssertionError(f"DRIVE steps {bad} off; {len(rec)} steps, eval "
                             f"batches {evals}, {launches} launches: want 18 "
                             "a step and an eval batch, finite losses")
    rels = [abs(k["loss"] - p["loss"]) / abs(p["loss"])
            for k, p in zip(rec, p_rec)]
    for i, (k, p) in enumerate(zip(rec, p_rec)):
        log(f"  DRIVE step {i + 1}: loss kernel {k['loss']:.7f} plain "
            f"{p['loss']:.7f} (rel {rels[i]:.2e}, limit {BF16_LOSS_TOLS[i]});"
            f" ms kernel {k['ms']:.1f} plain {p['ms']:.1f}")
    if len(p_rec) != DRIVE_STEPS or any(
            r > t for r, t in zip(rels, BF16_LOSS_TOLS)):
        raise AssertionError(f"DRIVE training, kernel vs plain: {rels}")
    log(f"[phase {tag}] (c) cli/train2d.py --dataset DRIVE, base-64 bf16 UNet "
        f"at {DRIVE_RES}², batch {DRIVE_BATCH}: {launches} kernel-1 launches "
        f"({len(rec)} steps, {len(evals)} eval batches, 18 each); run "
        f"{wall:.2f} s (plain {p_wall:.2f} s)")
    return {"launches": launches, "split": sizes, "losses": [
        r["loss"] for r in rec], "rel_gaps": rels, "step_ms": [
        r["ms"] for r in rec], "plain_step_ms": [r["ms"] for r in p_rec],
        "wall_s": wall, "items_s": items_s}


def _dsb_formats(seed: int, workdir: str, tag: str = "27",
                 groups=("dsb_c1", "dsb_c3"),
                 what: str = "TIFF, GIF and BMP") -> dict:
    """(d) cli/predict3d.py with DSB2018Dataset and DSB2018Predictor over
    the fixtures' 1- and 3-channel directories ``groups`` (TIFF, GIF and
    BMP, or JPEG), a seeded UNet2D each; every map against the plain path
    within phase 21's limit."""
    import numpy as np
    import torch

    from mdeical_image_segmentation_tpu_torch.cli import predict3d
    from mdeical_image_segmentation_tpu_torch.data.loaders import (
        get_test_loaders,
    )
    from mdeical_image_segmentation_tpu_torch.infer import (
        predictor as predictor_lib,
    )
    from mdeical_image_segmentation_tpu_torch.utils import hdf5, yaml_io

    pred_cfg = read_yaml_subset(PREDICT_YML)
    total = {k: 0 for k in KERNELS_3D}
    images, worst = 0, 0.0
    get = predictor_lib.get_predictor
    for group in groups:
        ch = int(group[-1])
        root = os.path.join(IMAGE_FIXTURES, group)
        n = len(os.listdir(os.path.join(root, "images")))
        model = dict(DSB_MODEL, in_channels=ch)
        cfg = {"model": model,
               "model_path": _initial_checkpoint(model, seed + ch, workdir,
                                                 f"dsb{tag}_c{ch}"),
               "output_dir": os.path.join(workdir, f"dsb{tag}_c{ch}_out"),
               "predictor": {"name": "DSB2018Predictor"},
               "loaders": {"dataset": "DSB2018Dataset",
                           "batch_size": DSB_BATCH,
                           "test": {"file_paths": [root], "transformer":
                                    pred_cfg["loaders"]["test"]["transformer"]}}}
        os.makedirs(cfg["output_dir"])
        cfg_path = os.path.join(workdir, f"dsb{tag}_c{ch}.yml")
        with open(cfg_path, "w") as f:
            f.write(yaml_io.dumps(cfg))
        made = []

        def instrumented(model, output_dir, config, **kw):
            p = get(model, output_dir, config, **kw)
            made.append(p)
            return p

        predictor_lib.get_predictor = instrumented
        try:
            torch.cuda.synchronize()
            _zero_counts()
            (files,) = predict3d.main(["--config", cfg_path])
            torch.cuda.synchronize()
            launches = _counts()
        finally:
            predictor_lib.get_predictor = get
        per_batch = 2 * (2 * DSB_MODEL["num_levels"] - 1)
        batches = -(-n // DSB_BATCH)
        want = {"gcr_conv3d": 0, "gn_stats": per_batch * batches,
                "gn_affine": per_batch * batches, "gn_bwd_reduce": 0,
                "gn_bwd_dx": 0, "overlap_add": 0}
        if len(files) != n or launches != want:
            raise AssertionError(f"{group}: {launches} for {len(files)} "
                                 f"files, want {want} for {n}")
        with plain_path():
            plain = get(made[0].model, os.path.join(workdir,
                                                    f"dsb{tag}_c{ch}_plain"),
                        {"model": model, "predictor": cfg["predictor"]})
            os.makedirs(plain.output_dir)
            (loader,) = get_test_loaders(cfg)
            plain_files = plain(loader)
        for f_kernel, f_plain in zip(sorted(files), sorted(plain_files)):
            with hdf5.File(f_kernel) as f, hdf5.File(f_plain) as g:
                p, q = f["predictions"][:], g["predictions"][:]
            err = float(np.abs(p - q).max())
            worst = max(worst, err)
            if (p.shape != (32, 48) or not np.isfinite(p).all()
                    or err > UNET3D_MAP_TOL * max(1.0,
                                                  float(np.abs(q).max()))):
                raise AssertionError(f"{f_kernel}: {p.shape}, kernel vs "
                                     f"plain {err:.3e}")
        for k in KERNELS_3D:
            total[k] += launches[k]
        images += n
    log(f"[phase {tag}] (d) DSB2018Predictor over {images} {what} "
        f"images (1 and 3 channels): kernel vs plain max |diff| {worst:.3e} "
        f"(limit {UNET3D_MAP_TOL}); launches {total}")
    return {"images": images, "err": worst, "launches": total}


def phase_image_formats(seed: int, workdir: str) -> dict:
    """Phase 27: (a) the fixtures against their manifest; (b) DRIVE-sized
    TIFF, GIF and BMP files served beside their PNG twins; (c) a DRIVE
    directory through cli/train2d.py; (d) DSB2018 over TIFF, GIF and
    BMP."""
    workdir = os.path.join(workdir, "phase27")
    os.makedirs(workdir)
    t0 = time.perf_counter()
    fixtures = _check_fixtures()
    fixtures["s"] = time.perf_counter() - t0
    log(f"[phase 27] (a) {fixtures['images']} TIFF, GIF and BMP fixtures "
        f"(and {fixtures['pngs']} PNGs, {fixtures['datasets']} HDF5 "
        f"datasets) equal to the manifest in {fixtures['s']:.2f} s")
    t0 = time.perf_counter()
    files = drive_sized_files(workdir)
    log(f"[phase 27] wrote the DRIVE-sized files in "
        f"{time.perf_counter() - t0:.2f} s")
    serve = _formats_serve(seed, workdir, files)
    drive = _drive_train(seed, workdir, files)
    dsb = _dsb_formats(seed, workdir)
    return {"fixtures": fixtures, "serve": serve, "drive": drive, "dsb": dsb,
            "launches": {"dsb_formats": dsb["launches"]},
            "kernel1": {"formats_serve": serve["launches"],
                        "drive_train": drive["launches"]}}


# ---------------------------------------------------------------------------
# Phase 28: JPEG as PIL and imageio read it (libjpeg-turbo's bits), decoded
# by the host C of csrc/jpeg_decode.c: the fixtures, DRIVE-sized JPEGs
# served and trained from, DSB2018 over JPEG directories
# ---------------------------------------------------------------------------

JPEG_DRIVE = ("baseline_420_q75", "q95_444", "progressive_422",
              "optimized_420", "restart_rows1_420")
JPEG_MANUAL = "grey_manual"


def jpeg_drive_files() -> dict:
    """The committed DRIVE-sized JPEGs: {variant: (path, {"L": pixels,
    "RGB": pixels})}, the pixels the port decodes, each held to PIL's
    SHA-256 in the manifest first (the PNG twins are written from them)."""
    from mdeical_image_segmentation_tpu_torch.utils import image

    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)["image_formats"]
    files = {}
    for name in JPEG_DRIVE + (JPEG_MANUAL,):
        key = f"jpeg_drive/{name}.jpg"
        path = os.path.join(IMAGE_FIXTURES, key)
        px = {m: image.read(path, m) for m in ("L", "RGB")}
        for m in ("L", "RGB"):
            if fixture_entry(px[m]) != manifest[key][f"pil_{m}"]:
                raise AssertionError(f"{key}: convert({m!r}) is not PIL's")
        files[name] = (path, px)
    return files


def phase_jpeg(seed: int, workdir: str) -> dict:
    """Phase 28: (a) the JPEG fixtures against their manifest; (b)
    DRIVE-sized JPEGs served beside their PNG twins; (c) a DRIVE directory
    of JPEGs through cli/train2d.py; (d) DSB2018 over JPEG directories."""
    workdir = os.path.join(workdir, "phase28")
    os.makedirs(workdir)
    t0 = time.perf_counter()
    fixtures = _check_fixtures(jpeg=True)
    fixtures["s"] = time.perf_counter() - t0
    log(f"[phase 28] (a) {fixtures['images']} JPEG fixtures equal to the "
        f"manifest in {fixtures['s']:.2f} s (the first decode builds "
        "csrc/jpeg_decode.c)")
    files = jpeg_drive_files()
    serve = _formats_serve(seed, workdir, files, tag="28")
    drive = _drive_train(seed, workdir, files, tag="28", images=JPEG_DRIVE,
                         label=JPEG_MANUAL, what="JPEG")
    dsb = _dsb_formats(seed, workdir, tag="28",
                       groups=("jpeg_c1", "jpeg_c3"), what="JPEG")
    return {"fixtures": fixtures, "serve": serve, "drive": drive, "dsb": dsb,
            "launches": {"dsb_jpeg": dsb["launches"]},
            "kernel1": {"jpeg_serve": serve["launches"],
                        "jpeg_drive_train": drive["launches"]}}


ORBAX_FIXTURES = os.path.join(FIXTURES, "orbax")
# configs/unet3d_train.yml's UNet3D (f_maps 64, 4 levels, 16,318,691
# parameters) with its two Adam moments, in float32
ORBAX_FULL_BYTES = 3 * 16_318_691 * 4
ORBAX_RATE_COPIES = 40   # the TP checkpoint's chunk frames, back to back
ORBAX_REPEATS = 5        # decode and read times: best of 5, warm
ORBAX_JAX_LOSS_TOL = 1e-4  # resumed losses vs the JAX package's own resume
ORBAX_STEPS = 3
ORBAX_CONVS = 6          # 'gcr' SingleConvs of the fixtures' 2-level UNet3D
ORBAX_LAYOUTS = {"orbax_tp": {"model_axis": 2, "tensor_parallel": True},
                 "orbax_zero1": {"zero1": True}}


def _orbax_manifest() -> dict:
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return json.load(f)["orbax"]


def _flat_tree(tree, prefix: str = "") -> dict:
    """A restored tree's leaves by their ``.``-joined path, ``{}`` as a
    leaf."""
    if not isinstance(tree, dict) or not tree:
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat_tree(v, f"{prefix}.{k}" if prefix else k))
    return out


def _leaf_matches(value, entry: dict) -> bool:
    if "none" in entry:
        return value is None
    if "empty" in entry:
        return value == {}
    if "number" in entry:
        return value == entry["value"]
    return fixture_entry(value) == entry


def _orbax_read(manifest: dict) -> dict:
    """(a) the zstd frames, OCDBT probes, zarr arrays and checkpoints of
    ``tests/fixtures/orbax`` against the manifest; the decoder's rate and
    each checkpoint's read."""
    import hashlib

    import numpy as np

    from mdeical_image_segmentation_tpu_torch.train.orbax_ckpt import (
        OrbaxCheckpointer,
    )
    from mdeical_image_segmentation_tpu_torch.utils import zarr2, zstd
    from mdeical_image_segmentation_tpu_torch.utils.ocdbt import KvStore

    def read(name):
        with open(os.path.join(ORBAX_FIXTURES, name), "rb") as f:
            return f.read()

    t0 = time.perf_counter()
    zstd.decompress(read(sorted(manifest["zstd"])[0]))
    build_s = time.perf_counter() - t0
    for name, want in sorted(manifest["zstd"].items()):
        out = zstd.decompress(read(name))
        got = {"length": len(out), "sha256": hashlib.sha256(out).hexdigest()}
        if got != want:
            raise AssertionError(f"{name} decodes to {got}, want {want}")
    for name, want in sorted(manifest["ocdbt"].items()):
        kv = KvStore(os.path.join(ORBAX_FIXTURES, name))
        got = {k.hex(): {"length": len(v),
                         "sha256": hashlib.sha256(v).hexdigest()}
               for k in kv.list() for v in [kv.read(k)]}
        if got != want:
            raise AssertionError(f"{name}: keys and values differ from "
                                 "tensorstore's")
    kv = KvStore(os.path.join(ORBAX_FIXTURES, "zarr"))
    for name, want in sorted(manifest["zarr"].items()):
        got = fixture_entry(zarr2.read_array(
            lambda key: kv.read(key) if key in kv else None,
            name.split("/", 1)[1]))
        if got != want:
            raise AssertionError(f"{name} reads as {got}, want {want}")
    # the decoder alone: the TP checkpoint's chunks (float32 weights and
    # moments at orbax's level 1) decoded back to back in one call
    tp = KvStore(os.path.join(ORBAX_FIXTURES, "tp", "orbax", "last",
                              "ocdbt.process_0"))
    frames = [tp.read(k) for k in tp.list() if not k.endswith(b".zarray")]
    if not all(f[:4] == zstd.MAGIC for f in frames):
        raise AssertionError("a chunk of the TP checkpoint is not a zstd "
                             "frame")
    stream = b"".join(frames) * ORBAX_RATE_COPIES
    out_bytes, best = 0, float("inf")
    for _ in range(ORBAX_REPEATS):
        t0 = time.perf_counter()
        out_bytes = len(zstd.decompress(stream))
        best = min(best, time.perf_counter() - t0)
    rate = out_bytes / best / 1e6
    reads = {}
    for name, want in sorted(manifest["checkpoints"].items()):
        d, which = name.rsplit("/", 1)
        ck = OrbaxCheckpointer(os.path.join(ORBAX_FIXTURES, d))
        ms = float("inf")
        for _ in range(ORBAX_REPEATS):
            t0 = time.perf_counter()
            tree = ck.restore(best=which == "best")
            ms = min(ms, (time.perf_counter() - t0) * 1e3)
        flat = _flat_tree(tree)
        bad = sorted(set(flat) ^ set(want)) or [
            k for k, e in want.items() if not _leaf_matches(flat[k], e)]
        if bad:
            raise AssertionError(f"{name}: leaves {bad[:5]} differ from the "
                                 "JAX package's restore")
        nbytes = sum(np.asarray(v).nbytes for v in flat.values()
                     if v is not None and not isinstance(v, dict))
        reads[name] = {"ms": ms, "leaves": len(flat), "bytes": nbytes}
    tp_read = reads["tp/orbax/last"]
    # an estimate, not a measurement: the full-width checkpoint has the
    # fixture's tree (the same 69 leaves), so its read is taken as the
    # fixture's read plus its bytes at the decoder's rate
    estimate_s = tp_read["ms"] / 1e3 + ORBAX_FULL_BYTES / 1e6 / rate
    out = {"build_and_first_decode_s": build_s, "frames": len(frames),
           "decoded_mb": out_bytes / 1e6, "decode_mb_per_s": rate,
           "reads": reads, "full_width_read_estimate_s": estimate_s}
    log(f"[phase 29] (a) {len(manifest['zstd'])} zstd frames, "
        f"{len(manifest['ocdbt'])} OCDBT probes, {len(manifest['zarr'])} "
        f"zarr arrays and {len(reads)} checkpoints equal to the manifest "
        f"(the first decode built csrc/zstd_decompress.c: {build_s:.2f} s); "
        f"decoder {rate:.1f} MB/s of output over {len(frames)} chunk frames "
        f"x {ORBAX_RATE_COPIES} ({out_bytes / 1e6:.1f} MB, best of "
        f"{ORBAX_REPEATS}, this machine's CPU); reads: "
        + ", ".join(f"{k} {v['ms']:.1f} ms ({v['bytes'] / 1e3:.0f} kB)"
                    for k, v in reads.items())
        + f"; the full-width checkpoint's read ({ORBAX_FULL_BYTES / 2**20:.0f}"
        f" MiB of arrays) estimated at {estimate_s:.2f} s (the TP fixture's "
        "read plus those bytes at the decoder's rate)")
    return out


def _orbax_state(trainer):
    """The whole parameters, Adam moments and step of a trainer in the JAX
    tree's paths (numpy), as the checkpoint's manifest names them."""
    import numpy as np

    from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
        state_dict_to_flax,
    )

    params = {k: p.detach().cpu() for k, p in
              trainer.model.named_parameters()}
    states = [trainer.optimizer.state[p]
              for p in trainer.model.parameters()]
    mu = {k: st["exp_avg"].cpu() for k, st in zip(params, states)}
    nu = {k: st["exp_avg_sq"].cpu() for k, st in zip(params, states)}
    flat = {}
    for prefix, sd in (("model_state_dict.params", params),
                       ("optimizer_state_dict.inner_state.0.mu", mu),
                       ("optimizer_state_dict.inner_state.0.nu", nu)):
        flat.update(_flat_tree(state_dict_to_flax(sd)["params"], prefix))
    # copies: the steps that follow update the tensors in place
    return {k: np.array(v) for k, v in flat.items()}, {
        "step": {float(st["step"]) for st in states},
        "counters": (trainer.num_iterations, trainer.num_epochs,
                     trainer.best_eval_score)}


def _orbax_resume(run: str, want: dict, entries: dict, workdir: str,
                  plain: bool) -> dict:
    """(b) one JAX run's orbax checkpoint (a copy) resumed by
    cli/train3d.py in a world of 1 for ``ORBAX_STEPS`` steps, on the
    kernel path or the plain path: the restored state against the
    manifest, each step's ms, loss and launches, the logged losses."""
    import numpy as np
    import torch

    from mdeical_image_segmentation_tpu_torch.cli import train3d
    from mdeical_image_segmentation_tpu_torch.train import trainer3d
    from mdeical_image_segmentation_tpu_torch.transforms import volume
    from mdeical_image_segmentation_tpu_torch.utils import yaml_io

    script = fixture_script()
    tag = f"{run}_{'plain' if plain else 'kernel'}"
    copy = os.path.join(workdir, f"orbax_{tag}")
    shutil.copytree(os.path.join(ORBAX_FIXTURES, run), copy)
    cfg = script.orbax_config(
        os.path.join(ORBAX_FIXTURES, "volumes", "train.h5"),
        os.path.join(ORBAX_FIXTURES, "volumes", "val.h5"),
        os.path.join(copy, "unused"), batch_size=want["data_axis"],
        resume=os.path.join(copy, "orbax"),
        max_num_iterations=want["num_iterations"] + ORBAX_STEPS - 2,
        validate_after_iters=1000)
    yml = os.path.join(workdir, f"orbax_{tag}.yml")
    with open(yml, "w") as f:
        f.write(yaml_io.dumps(cfg))
    rec, made = [], []
    create = trainer3d.create_trainer

    def instrumented(config):
        t = create(config)
        made.append(_orbax_state(t))
        _instrument(t, rec)
        return t

    trainer3d.create_trainer = instrumented
    volume.GLOBAL_RANDOM_STATE = np.random.RandomState(47)
    _zero_counts()
    try:
        with plain_path() if plain else contextlib.nullcontext():
            t0 = time.perf_counter()
            trainer = train3d.main(["--config", yml])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _counts()
    finally:
        trainer3d.create_trainer = create
    state, extra = made[0]
    bad = [k for k, v in state.items() if fixture_entry(v) != entries[k]]
    counters = tuple(entries[k]["value"] for k in (
        "num_iterations", "num_epochs", "best_eval_score"))
    count = entries["optimizer_state_dict.inner_state.0.count"]
    if (bad or extra["counters"] != counters or len(extra["step"]) != 1
            or fixture_entry(np.asarray(int(extra["step"].pop()), np.int32))
            != count):
        raise AssertionError(f"{run}: the resumed state differs from the "
                             f"JAX checkpoint: {bad[:5]}, counters "
                             f"{extra['counters']} vs {counters}")
    if trainer.checkpoint_dir != copy:
        raise AssertionError(f"checkpoint_dir {trainer.checkpoint_dir}, "
                             f"want the resumed run's {copy}")
    want_launches = {"gcr_conv3d": ORBAX_CONVS, "gn_stats": ORBAX_CONVS,
                     "gn_affine": ORBAX_CONVS, "gn_bwd_reduce": ORBAX_CONVS,
                     "gn_bwd_dx": ORBAX_CONVS - 1, "overlap_add": 0}
    if plain:
        want_launches = {k: 0 for k in want_launches}
    if len(rec) != ORBAX_STEPS or any(
            r["launches"] != want_launches or not np.isfinite(r["loss"])
            for r in rec):
        raise AssertionError(f"{tag}: {len(rec)} steps, launches "
                             f"{[r['launches'] for r in rec]}, want "
                             f"{ORBAX_STEPS} of {want_launches}")
    logged = script.logged(copy, "train_loss_avg")
    return {"rec": rec, "launches": launches, "wall_s": wall,
            "logged": logged, "whole": state}


def mp_orbax_runs(seed: int, out: str, rank: int):
    """(c) on one rank: the JAX TP run's orbax checkpoint (a copy) resumed
    by ``create_trainer`` in the layout of ``out``'s name; this rank's
    parameter and moment blocks with the dim each is sliced on."""
    from mdeical_image_segmentation_tpu_torch.parallel import tensor as tp
    from mdeical_image_segmentation_tpu_torch.parallel.zero import (
        Zero1Optimizer,
    )
    from mdeical_image_segmentation_tpu_torch.train import trainer3d

    layout = os.path.basename(os.path.normpath(out))
    copy = os.path.join(out, f"tp{rank}")
    shutil.copytree(os.path.join(ORBAX_FIXTURES, "tp"), copy)
    cfg = fixture_script().orbax_config(
        os.path.join(ORBAX_FIXTURES, "volumes", "train.h5"),
        os.path.join(ORBAX_FIXTURES, "volumes", "val.h5"),
        os.path.join(copy, "unused"), ORBAX_LAYOUTS[layout],
        resume=os.path.join(copy, "orbax"))
    t = trainer3d.create_trainer(cfg)
    opt = t.optimizer
    if isinstance(opt, Zero1Optimizer):
        inner, entries = opt.inner, opt.named_slices()
        idx, n = t.mesh.rank, t.mesh.size
    else:
        dims = tp.sharded_dims(t.model)
        inner, idx, n = opt, t.mesh.model_rank, t.mesh.model_size
        entries = [(k, p, dims.get(k)) for k, p in t.model.named_parameters()]
    return {"idx": idx, "n": n, "device": str(next(t.model.parameters()).device),
            "blocks": {k: {"dim": dim,
                           "param": s.detach().cpu().numpy(),
                           "exp_avg": inner.state[s]["exp_avg"].cpu().numpy(),
                           "exp_avg_sq":
                               inner.state[s]["exp_avg_sq"].cpu().numpy()}
                       for k, s, dim in entries}}


MP_ROLES.update({layout: (mp_orbax_runs, 2) for layout in ORBAX_LAYOUTS})


def _orbax_layouts(workdir: str, whole: dict) -> dict:
    """(c) two gloo ranks on the card in each layout of ``ORBAX_LAYOUTS``:
    every rank's blocks the slice of (b)'s whole arrays, to the bit."""
    import numpy as np

    from mdeical_image_segmentation_tpu_torch.utils.param_bridge import (
        flax_to_state_dict,
    )

    def state_dict(prefix):
        tree = {}
        for k, v in whole.items():
            if k.startswith(prefix + "."):
                node = tree
                *path, leaf = k[len(prefix) + 1:].split(".")
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = v
        return {k: v.numpy() for k, v in flax_to_state_dict(tree).items()}

    ref = {"param": state_dict("model_state_dict.params"),
           "exp_avg": state_dict("optimizer_state_dict.inner_state.0.mu"),
           "exp_avg_sq": state_dict("optimizer_state_dict.inner_state.0.nu")}
    out = {}
    for layout in ORBAX_LAYOUTS:
        t0 = time.perf_counter()
        ranks = _dp_ranks(os.path.join(workdir, layout), 2, "--mp-worker",
                          MP_TIMEOUT_S)
        sliced = 0
        for r in ranks:
            for name, b in r["blocks"].items():
                for key in ("param", "exp_avg", "exp_avg_sq"):
                    want = ref[key][name]
                    if b["dim"] is not None:
                        size = want.shape[b["dim"]] // r["n"]
                        want = np.take(want, np.arange(
                            r["idx"] * size, (r["idx"] + 1) * size),
                            axis=b["dim"])
                    if (b[key].shape != want.shape
                            or not np.array_equal(b[key], want)):
                        raise AssertionError(f"{layout} rank {r['idx']}: "
                                             f"{name} {key} is not its slice")
                sliced += b["dim"] is not None
        if not sliced:
            raise AssertionError(f"{layout}: no tensor was sliced")
        out[layout] = {"sliced": sliced, "wall_s": time.perf_counter() - t0,
                       "devices": sorted({r["device"] for r in ranks})}
        log(f"[phase 29] (c) {layout}: 2 gloo ranks, {sliced} sliced "
            f"tensors (of parameters and moments, over both ranks) equal to "
            f"the slices of the whole, in {out[layout]['wall_s']:.1f} s")
    return out


def phase_orbax(seed: int, workdir: str, layouts: bool = True) -> dict:
    """Phase 29: (a) the orbax fixtures read against their manifest, the
    zstd decoder's rate; (b) the JAX TP and ZeRO-1 checkpoints resumed by
    cli/train3d.py for 3 steps on the kernel and the plain path; (c) with
    ``layouts``, the TP checkpoint resumed by two gloo ranks with TP and
    with ZeRO-1."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    workdir = os.path.join(workdir, "phase29")
    os.makedirs(workdir)
    manifest = _orbax_manifest()
    read = _orbax_read(manifest)
    runs, wholes, launches = {}, {}, {k: 0 for k in KERNELS_3D}
    for run, want in sorted(manifest["runs"].items()):
        entries = manifest["checkpoints"][want["checkpoint"] + "/last"]
        kernel = _orbax_resume(run, want, entries, workdir, plain=False)
        plain = _orbax_resume(run, want, entries, workdir, plain=True)
        _compare_runs(f"orbax {run} resume", kernel["rec"], plain["rec"],
                      ORBAX_STEPS)
        jax_losses = want["resumed_train_loss_avg"]
        gaps = {}
        for step, loss in jax_losses.items():
            got = kernel["logged"].get(step)
            gaps[step] = (float("inf") if got is None
                          else abs(got - loss) / abs(loss))
        if set(kernel["logged"]) != set(jax_losses) or max(
                gaps.values()) > ORBAX_JAX_LOSS_TOL:
            raise AssertionError(f"orbax {run}: logged losses "
                                 f"{kernel['logged']} vs the JAX package's "
                                 f"{jax_losses} (limit {ORBAX_JAX_LOSS_TOL}"
                                 " relative)")
        wholes[run] = kernel["whole"]
        for k in launches:
            launches[k] += kernel["launches"][k]
        steady = statistics.median(r["ms"] for r in kernel["rec"][1:])
        plain_steady = statistics.median(r["ms"] for r in plain["rec"][1:])
        runs[run] = {"step_ms": [r["ms"] for r in kernel["rec"]],
                     "plain_step_ms": [r["ms"] for r in plain["rec"]],
                     "steady_ms": steady, "plain_steady_ms": plain_steady,
                     "losses": kernel["logged"], "jax_losses": jax_losses,
                     "jax_gaps": gaps, "wall_s": kernel["wall_s"],
                     "launches": kernel["launches"]}
        log(f"[phase 29] (b) {run}: cli/train3d.py resumed the JAX "
            f"checkpoint at iteration {want['num_iterations']} (state equal "
            f"to the manifest), {ORBAX_STEPS} steps of global batch "
            f"{want['data_axis']}: steps {runs[run]['step_ms']} ms (plain "
            f"{runs[run]['plain_step_ms']}), losses {kernel['logged']} vs "
            f"the JAX package's {jax_losses} (rel {gaps}, limit "
            f"{ORBAX_JAX_LOSS_TOL}); launches {kernel['launches']}")
    out = {"read": read, "runs": runs, "launches": launches}
    if layouts:
        out["layouts"] = _orbax_layouts(workdir, wholes["tp"])
    return out


# ---------------------------------------------------------------------------
# 30. The HDF5 files of ROADMAP item 20: external links, virtual datasets,
# szip, n-bit, external raw storage and committed datatypes through
# predict3d and the Lazy path
# ---------------------------------------------------------------------------

ITEM20_FIXTURES = os.path.join(FIXTURES, "h5_item20")
ITEM20_PHANTOMS = {"vds": "phantom_vds.h5", "ext": "phantom_ext.h5",
                   "szip": "phantom_szip.h5", "nbit": "phantom_nbit.h5"}
ITEM20_READ_REPEATS = 5   # whole-volume reads: best of 5, warm
SZIP_RATE_REPEATS = 5     # the szip decoder over the phantom's chunks


def _check_item20_fixtures() -> dict:
    """(a) every file of ``tests/fixtures/h5_item20`` read by the port
    against the manifest h5py wrote: each group's keys(), each dataset's
    shape, dtype and SHA-256 (external raw files found beside their file
    through ``HDF5_EXTFILE_PREFIX=${ORIGIN}``)."""
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)["h5_item20"]
    old = os.environ.get("HDF5_EXTFILE_PREFIX")
    os.environ["HDF5_EXTFILE_PREFIX"] = "${ORIGIN}"
    try:
        n_ds = _check_h5_files(manifest, ITEM20_FIXTURES)
    finally:
        if old is None:
            os.environ.pop("HDF5_EXTFILE_PREFIX")
        else:
            os.environ["HDF5_EXTFILE_PREFIX"] = old
    return {"files": len(manifest), "datasets": n_ds}


def _szip_rate(path: str) -> dict:
    """(d) ``csrc/szip_decompress.c`` over every chunk of the szip phantom
    (read from the file first): MB/s of output, best of
    ``SZIP_RATE_REPEATS``, on the host CPU."""
    from mdeical_image_segmentation_tpu_torch.utils import hdf5, szip

    with hdf5.File(path) as f:
        ds = f["raw"]
        (cd,) = [v for fid, v in ds._filters if fid == hdf5.FILTER_SZIP]
        chunks = [f._store.read(addr, size) for addr, size, mask in
                  ds._chunk_index().values() if not mask]
    out = sum(len(szip.hdf5_chunk(c, cd)) for c in chunks)  # warm
    best = float("inf")
    for _ in range(SZIP_RATE_REPEATS):
        t0 = time.perf_counter()
        for c in chunks:
            szip.hdf5_chunk(c, cd)
        best = min(best, time.perf_counter() - t0)
    return {"chunks": len(chunks), "in_bytes": sum(map(len, chunks)),
            "out_bytes": out, "best_s": best, "mb_per_s": out / best / 1e6,
            "options": list(cd)}


def phase_item20_files(seed: int, workdir: str) -> dict:
    """Phase 30: (a) the fixtures against their manifest; (b) predict3d
    (Standard) over the phantom as a VDS, through an external link, with
    szip and as n-bit 12-bit samples, each map to the bit that of a plain
    v0 copy of the same values; (c) LazyPredictor twice on a copy of the
    VDS and its sources, the memo appended with "r+" and read back; (d)
    the szip decoder's rate."""
    import numpy as np

    from mdeical_image_segmentation_tpu_torch.data.volume_utils import (
        mirror_pad,
    )
    from mdeical_image_segmentation_tpu_torch.utils import hdf5

    workdir = os.path.join(workdir, "phase30")
    os.makedirs(workdir)
    t0 = time.perf_counter()
    fixtures = _check_item20_fixtures()
    fixtures["s"] = time.perf_counter() - t0
    log(f"[phase 30] (a) {fixtures['datasets']} datasets of "
        f"{fixtures['files']} item-20 HDF5 fixtures equal to the manifest "
        f"in {fixtures['s']:.2f} s")

    # (b) each file and the v0 copy of its values through the same command
    paths = {k: os.path.join(ITEM20_FIXTURES, v)
             for k, v in ITEM20_PHANTOMS.items()}
    values = {}
    for tag, path in paths.items():
        with hdf5.File(path) as f:
            values[tag] = f["raw"][:]
    raw = values["vds"]
    for tag in ("ext", "szip"):
        if not np.array_equal(values[tag], raw):
            raise AssertionError(f"the {tag} phantom reads otherwise than "
                                 "the VDS one")
    if not np.array_equal(values["nbit"], raw.astype(np.uint16) * 16):
        raise AssertionError("the n-bit phantom is not the phantom x 16")
    paths["v0"] = os.path.join(workdir, "phantom_v0.h5")
    write_h5_volume(paths["v0"], raw)
    paths["nbit_v0"] = os.path.join(workdir, "phantom_nbit_v0.h5")
    write_h5_volume(paths["nbit_v0"], values["nbit"])

    reads = {tag: _best_read_s(path, ITEM20_READ_REPEATS)
             for tag, path in paths.items()}
    log(f"[phase 30] (b) whole-volume reads of the {raw.shape} phantom by "
        f"the port (best of {ITEM20_READ_REPEATS}, warm): "
        + ", ".join(f"{k} {v:.3f} s" for k, v in reads.items()))
    cfg = read_yaml_subset(PREDICT_YML)
    ckpt = _initial_checkpoint(cfg["model"], seed, workdir, "phantom_unet3d")
    std = {tag: _predict_phantom(path, ckpt, os.path.join(workdir, tag),
                                 lazy=False)
           for tag, path in paths.items()}
    for tag in ITEM20_PHANTOMS:
        plain = std["nbit_v0" if tag == "nbit" else "v0"]["map"]
        got = std[tag]["map"]
        if got.shape != (1,) + raw.shape or not np.isfinite(got).all() or (
                not np.array_equal(got, plain)):
            raise AssertionError(f"{tag}: the map {got.shape} differs from "
                                 "its v0 copy's")
    log("[phase 30] (b) predict3d (StandardPredictor): " + ", ".join(
        f"{k} {v['wall_s']:.2f} s (batch {v['batch_ms']:.1f} ms)"
        for k, v in std.items()) + "; the VDS, external-link, szip and "
        "n-bit maps equal their v0 copies' to the bit; launches "
        f"{std['vds']['launches']} each")

    # (c) LazyPredictor appends the memo to a copy of the VDS file
    lazy_dir = os.path.join(workdir, "lazy")
    os.makedirs(lazy_dir)
    for name in ("phantom_vds.h5", "phantom_vds_a.h5", "phantom_vds_b.h5"):
        shutil.copy(os.path.join(ITEM20_FIXTURES, name), lazy_dir)
    lazy_path = os.path.join(lazy_dir, "phantom_vds.h5")
    halo = cfg["loaders"]["test"]["slice_builder"]["halo_shape"]
    memo = "raw_padded_" + "x".join(str(h) for h in halo)
    a = std["vds"]["map"]
    scale = max(1.0, float(np.abs(a).max()))
    lazy, launches = {}, {k: 0 for k in KERNELS_3D}
    for run in ("memo written", "memo read"):
        size = os.path.getsize(lazy_path)
        lazy[run] = _predict_phantom(lazy_path, ckpt, os.path.join(
            workdir, f"lazy_{len(lazy)}"), lazy=True)
        err = float(np.abs(lazy[run]["map"] - a).max())
        if err > LAZY_MAP_TOL * scale:
            raise AssertionError(f"lazy {run}: the map differs from (b)'s by "
                                 f"{err:.3e} (limit {LAZY_MAP_TOL} x "
                                 f"{scale:.3f})")
        lazy[run]["err"] = err
        for k in KERNELS_3D:
            launches[k] += lazy[run]["launches"][k]
        with hdf5.File(lazy_path) as f:
            keys = f.keys()
            got_memo = f[memo][:]
            still = f["raw"][:]
        if (keys != ["raw", memo] or not np.array_equal(still, raw)
                or not np.array_equal(got_memo, mirror_pad(raw, halo))):
            raise AssertionError(f"lazy {run}: {lazy_path} holds {keys}; "
                                 "the memo or the VDS reads otherwise")
        if run == "memo read" and os.path.getsize(lazy_path) != size:
            raise AssertionError("the second Lazy run wrote to the file")
        log(f"[phase 30] (c) LazyPredictor on the VDS, {run}: "
            f"{lazy[run]['wall_s']:.2f} s, map vs (b) max |diff| {err:.3e}; "
            f"the file holds {keys}, the VDS reads the phantom after the "
            "append")

    # (d) the szip decoder alone
    rate = _szip_rate(paths["szip"])
    log(f"[phase 30] (d) szip ({rate['options']}): {rate['chunks']} chunks, "
        f"{rate['in_bytes']} -> {rate['out_bytes']} bytes in "
        f"{rate['best_s'] * 1e3:.1f} ms, {rate['mb_per_s']:.1f} MB/s of "
        "output (best of 5, host CPU)")
    for r in list(std.values()) + list(lazy.values()):
        r.pop("map")
    return {"fixtures": fixtures, "reads": reads, "standard": std,
            "lazy": lazy, "szip": rate,
            "launches": {"item20_predict3d": {
                k: sum(std[t]["launches"][k] for t in ITEM20_PHANTOMS)
                for k in KERNELS_3D}, "item20_lazy": launches}}


def _single_conv_row(mp: dict) -> dict:
    """The kernels-line entry of kernel 1's single-conv launch (one of its
    two convs alone, as the 2D TP step runs it): launches on phase 25's
    TP path, times over the 18 TP shapes (bf16, N=32, Co/2)."""
    single = mp["kernels"]["single"]
    return {
        "name": "conv2d_relu",
        "route": "cuda",
        "source": "mdeical_image_segmentation_tpu_torch/csrc/double_conv2d.cu",
        "replaces": "mdeical_image_segmentation_tpu/ops/fused_conv.py:420",
        "launches": mp["single_conv_launches"],
        "launches_by_path": {"tp_2d": mp["single_conv_launches"]},
        "max_abs_err": single["err"],
        "ms": single["ms"],
        "plain_ms": single["plain_ms"],
        "bound_ms": single["bound_ms"],
        "bound_by": ("operations" if single["op_ms"] >= single["byte_ms"]
                     else "bytes"),
        # cuDNN's conv2d with the bias, one call (no relu)
        "library_ms": single["library_ms"],
        "device_ms": None,
    }


def _tp_k2(mp: dict) -> dict:
    k2 = mp["kernels"]["k2"]
    return {k: k2[k] for k in ("err", "ms", "plain_ms", "library_ms",
                               "bound_ms", "n")}


def _counts_from(rec):
    """The launches of a run's steps, summed."""
    return {k: sum(r["launches"][k] for r in rec) for k in KERNELS_3D}


def _int8_kernel_rows(int8: dict) -> list:
    """The kernels-line entries of ``int8_conv`` (the whole call, its
    quantize pass included) and ``int8_quantize`` (the pass alone); no TPU
    kernel behind either: the JAX package leaves its int8 conv and
    activation quantization to XLA.  Times at bench.py's int8 row shapes
    (b), cuDNN's float conv beside the conv; no one-call library int8 conv
    or int8 quantization of this rounding on CUDA."""
    src = "mdeical_image_segmentation_tpu_torch/csrc/int8_conv.cu"
    q = int8["quantize"]
    return [{
        "name": "int8_conv",
        "route": "cuda",
        "source": src,
        # no TPU kernel: the JAX package's int8 conv is XLA's
        "replaces": "mdeical_image_segmentation_tpu/ops/quant.py:123",
        "tpu_kernel": False,
        "launches": int8["launches"],
        "launches_by_path": int8["launches_by_path"],
        "max_abs_err": int8["max_abs_err"],
        "ms": int8["ms"],
        "plain_ms": int8["plain_ms"],
        "bound_ms": int8["bound_ms"],
        "bound_by": int8["bound_by"],
        "library_ms": None,
        "device_ms": int8["device_ms"],
        "cudnn_float_conv_ms": int8["cudnn_float_conv_ms"],
    }, {
        "name": "int8_quantize",
        "route": "cuda",
        "source": src,
        # no TPU kernel: XLA's _act_quant
        "replaces": "mdeical_image_segmentation_tpu/ops/quant.py:103",
        "tpu_kernel": False,
        # one a conv call, asserted equal to int8_conv's on every path
        "launches": int8["launches"],
        "launches_by_path": int8["launches_by_path"],
        "max_abs_err": 0.0,  # equal to _act_quant at every shape of (a)
        "ms": q["ms"],
        "plain_ms": q["plain_ms"],
        "bound_ms": q["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "device_ms": q["device_ms"],
    }]


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phase", type=int,
                        choices=(18, 19, 20, 21, 23, 24, 25, 26, 27, 28,
                                 29, 30),
                        default=None,
                        help="run the kernel build and this phase alone "
                        "(21: with phases 13 and 14, which it reads)")
    # one rank of phase 23 (b) or of phase 24 (b)-(c), started by the
    # phase itself
    parser.add_argument("--dp-worker", nargs=4, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--spatial-worker", nargs=4, default=None,
                        help=argparse.SUPPRESS)
    # one rank of phase 25 (a)-(d), started by the phase itself
    parser.add_argument("--mp-worker", nargs=4, default=None,
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    port = _import_port()
    if args.dp_worker:
        rank, world, dp_port, out = args.dp_worker
        return dp_worker(int(rank), int(world), int(dp_port), out)
    if args.spatial_worker:
        rank, world, sp_port, out = args.spatial_worker
        return spatial_worker(int(rank), int(world), int(sp_port), out)
    if args.mp_worker:
        rank, world, mp_port, out = args.mp_worker
        return mp_worker(int(rank), int(world), int(mp_port), out)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"port {port.__name__} from {ROOT}; torch {torch.__version__} "
        f"(CUDA {torch.version.cuda}); {torch.cuda.get_device_name(0)}")
    if args.phase == 18:
        from mdeical_image_segmentation_tpu_torch.ops import _build

        _build.load()
        _log_ptxas(_build.build_log_path().read_text())
        build_dir = os.path.join(ROOT, "build")
        os.makedirs(build_dir, exist_ok=True)
        workdir = tempfile.mkdtemp(prefix="chip_smoke_int8_", dir=build_dir)
        try:
            t_phase = time.time()
            int8 = phase_int8(SEED, workdir)
            log(f"[phase 18] int8 ok; wall {time.time() - t_phase:.1f} s")
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        log(f"int8 (phase 18): {json.dumps({k: v for k, v in int8.items() if k not in ('sums', 'counts')})}")
        print(smi)
        print(json.dumps({"kernels": _int8_kernel_rows(int8)}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}), flush=True)
        return 0
    if args.phase == 21:
        from mdeical_image_segmentation_tpu_torch.ops import _build

        _build.load()
        # TF32 off, as phase 1 leaves it for the whole script
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        build_dir = os.path.join(ROOT, "build")
        os.makedirs(build_dir, exist_ok=True)
        workdir = tempfile.mkdtemp(prefix="chip_smoke_21_", dir=build_dir)
        try:
            t_phase = time.time()
            cfg_train = phase_config_train(SEED, workdir, float("nan"))
            cfg_predict = phase_config_predict(SEED, workdir,
                                               cfg_train["best"])
            log(f"[phases 13-14] ok; wall {time.time() - t_phase:.1f} s")
            t_phase = time.time()
            rest = phase_pipeline_rest(SEED, workdir, cfg_train, cfg_predict)
            log(f"[phase 21] ok; wall {time.time() - t_phase:.1f} s")
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        log(f"phase 21 ({smi}): {json.dumps(rest)}")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}), flush=True)
        return 0
    if args.phase == 23:
        from mdeical_image_segmentation_tpu_torch.ops import _build

        _build.load()
        # TF32 off: the mode the CLIs pin, as phase 1 leaves it
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        build_dir = os.path.join(ROOT, "build")
        os.makedirs(build_dir, exist_ok=True)
        workdir = tempfile.mkdtemp(prefix="chip_smoke_23_", dir=build_dir)
        try:
            t_phase = time.time()
            dp = phase_data_parallel(SEED, workdir)
            log(f"[phase 23] ok; wall {time.time() - t_phase:.1f} s")
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        log(f"data parallel (phase 23, {smi}): {json.dumps(dp)}")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}), flush=True)
        return 0
    if args.phase == 24:
        from mdeical_image_segmentation_tpu_torch.ops import _build

        _build.load()
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        build_dir = os.path.join(ROOT, "build")
        os.makedirs(build_dir, exist_ok=True)
        workdir = tempfile.mkdtemp(prefix="chip_smoke_24_", dir=build_dir)
        try:
            t_phase = time.time()
            spatial = phase_spatial(SEED, workdir, float("nan"))
            log(f"[phase 24] ok; wall {time.time() - t_phase:.1f} s")
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        log(f"spatial (phase 24, {smi}): {json.dumps(spatial)}")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}), flush=True)
        return 0
    if args.phase == 25:
        from mdeical_image_segmentation_tpu_torch.ops import _build

        _build.load()
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        build_dir = os.path.join(ROOT, "build")
        os.makedirs(build_dir, exist_ok=True)
        workdir = tempfile.mkdtemp(prefix="chip_smoke_25_", dir=build_dir)
        try:
            t_phase = time.time()
            mp = phase_model_axis(SEED, workdir, _training_shapes(SEED))
            log(f"[phase 25] ok; wall {time.time() - t_phase:.1f} s")
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        log(f"model axis (phase 25, {smi}): {json.dumps(mp)}")
        print(smi)
        print(json.dumps({"kernels": [_single_conv_row(mp)]}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}), flush=True)
        return 0
    if args.phase == 26:
        from mdeical_image_segmentation_tpu_torch.ops import _build

        _build.load()
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        build_dir = os.path.join(ROOT, "build")
        os.makedirs(build_dir, exist_ok=True)
        workdir = tempfile.mkdtemp(prefix="chip_smoke_26_", dir=build_dir)
        try:
            t_phase = time.time()
            formats = phase_read_formats(SEED, workdir)
            log(f"[phase 26] ok; wall {time.time() - t_phase:.1f} s ({smi})")
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        log(f"file formats (phase 26, {smi}): {json.dumps(formats)}")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}), flush=True)
        return 0
    if args.phase == 30:
        from mdeical_image_segmentation_tpu_torch.ops import _build

        _build.load()
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        build_dir = os.path.join(ROOT, "build")
        os.makedirs(build_dir, exist_ok=True)
        workdir = tempfile.mkdtemp(prefix="chip_smoke_30_", dir=build_dir)
        try:
            t_phase = time.time()
            item20 = phase_item20_files(SEED, workdir)
            log(f"[phase 30] ok; wall {time.time() - t_phase:.1f} s ({smi})")
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        log(f"item-20 HDF5 files (phase 30, {smi}): {json.dumps(item20)}")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}), flush=True)
        return 0
    if args.phase == 29:
        from mdeical_image_segmentation_tpu_torch.ops import _build

        _build.load()
        build_dir = os.path.join(ROOT, "build")
        os.makedirs(build_dir, exist_ok=True)
        workdir = tempfile.mkdtemp(prefix="chip_smoke_29_", dir=build_dir)
        try:
            t_phase = time.time()
            orbax = phase_orbax(SEED, workdir)
            log(f"[phase 29] ok; wall {time.time() - t_phase:.1f} s ({smi})")
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        log(f"orbax (phase 29, {smi}): {json.dumps(orbax)}")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}), flush=True)
        return 0
    if args.phase in (27, 28):
        from mdeical_image_segmentation_tpu_torch.ops import _build

        _build.load()
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        build_dir = os.path.join(ROOT, "build")
        os.makedirs(build_dir, exist_ok=True)
        workdir = tempfile.mkdtemp(prefix=f"chip_smoke_{args.phase}_",
                                   dir=build_dir)
        try:
            t_phase = time.time()
            images = (phase_image_formats if args.phase == 27
                      else phase_jpeg)(SEED, workdir)
            log(f"[phase {args.phase}] ok; wall {time.time() - t_phase:.1f} "
                f"s ({smi})")
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        log(f"image formats (phase {args.phase}, {smi}): "
            f"{json.dumps(images)}")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}), flush=True)
        return 0
    if args.phase in (19, 20):
        from mdeical_image_segmentation_tpu_torch.ops import _build

        _build.load()
        build_dir = os.path.join(ROOT, "build")
        os.makedirs(build_dir, exist_ok=True)
        workdir = tempfile.mkdtemp(prefix=f"chip_smoke_{args.phase}_",
                                   dir=build_dir)
        try:
            t_phase = time.time()
            result = (phase_export if args.phase == 19 else phase_sam)(
                SEED, workdir)
            log(f"[phase {args.phase}] ok; wall {time.time() - t_phase:.1f} s")
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        log(f"phase {args.phase} ({smi}): {json.dumps(result)}")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}), flush=True)
        return 0

    t_phase = time.time()
    max_err, ms, plain_ms, dc_bound = phase_kernels(SEED)
    log(f"[phase 1] wall {time.time() - t_phase:.1f} s")
    build_dir = os.path.join(ROOT, "build")
    os.makedirs(build_dir, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=build_dir)
    shapes: set = set()
    try:
        t_phase = time.time()
        launches = phase_serve(SEED, workdir)
        log(f"[phase 2] wall {time.time() - t_phase:.1f} s")
        t_phase = time.time()
        model_cfg, ckpt, unet3d_launches, unet3d_err = phase_unet3d_predictor(
            SEED, workdir, shapes)
        log(f"[phase 3] UNet3D predictor ok; wall {time.time() - t_phase:.1f} s")
        t_phase = time.time()
        log("[phase 4] ResidualUNet3D f_maps 32, 5 levels, patch 48x96x96 + "
            "halo 8/16/16 on a 48x192x288 volume")
        res_launches, res_err = phase_residual_predictor(SEED, shapes)
        log(f"[phase 4] ResidualUNet3D predictor ok; wall "
            f"{time.time() - t_phase:.1f} s")
        t_phase = time.time()
        serve3d_launches = phase_serve3d(SEED, workdir, model_cfg, ckpt)
        log(f"[phase 5] wall {time.time() - t_phase:.1f} s")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    t_phase = time.time()
    train_shapes = _training_shapes(SEED)
    k3d = phase_kernels_3d(SEED, shapes, train_shapes)
    log(f"[phase 6] wall {time.time() - t_phase:.1f} s")

    t_phase = time.time()
    log(f"[phase 7] GroupNorm backward kernels at the training shapes: "
        f"{len(train_shapes['gn'])} GroupNorm inputs of UNet3D (80x170x170) "
        f"and ResidualUNet3D (64x128x128)")
    k3d.update(phase_gn_backward_kernels(SEED, train_shapes))
    log(f"[phase 7] wall {time.time() - t_phase:.1f} s")
    t_phase = time.time()
    log("[phase 8] gradients through gcr_fused_conv and GroupNorm vs "
        "autograd through the plain composition (TF32 off)")
    phase_train_forward_convs(SEED, train_shapes)
    grad_err = phase_autograd(SEED, train_shapes)
    log(f"[phase 8] wall {time.time() - t_phase:.1f} s")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_train_", dir=build_dir)
    try:
        t_phase = time.time()
        train_launches, step_ms, plain_step_ms, peak = phase_train_unet3d(
            SEED, workdir)
        log(f"[phase 9] UNet3D training ok; wall {time.time() - t_phase:.1f}"
            " s")
        t_phase = time.time()
        log("[phase 10] ResidualUNet3D f_maps 32, 5 levels, 64x128x128, two "
            "steps")
        res_train_launches = phase_train_residual(SEED, workdir)
        log(f"[phase 10] ResidualUNet3D training ok; wall "
            f"{time.time() - t_phase:.1f} s")
        t_phase = time.time()
        log("[phase 11] 2D training: kernel 1 at the training batch, "
            "double_conv2d's gradients, Trainer.train() of the base-64 bf16 "
            "UNet at 256²")
        dc_train = phase_dc_training_batch(SEED)
        train2d = phase_train_unet2d(SEED, workdir)
        log(f"[phase 11] 2D training ok; wall {time.time() - t_phase:.1f} s")
        t_phase = time.time()
        log("[phase 12] UNet-3+: Trainer.train() of UNet_3Plus at 512², "
            "remat off and on; the card against the CPU; DeepSup and CGM; "
            "serving")
        u3p = phase_train_unet3plus(SEED, workdir)
        log(f"[phase 12] UNet-3+ ok; wall {time.time() - t_phase:.1f} s")
        t_phase = time.time()
        log("[phase 13] cli/train3d.py on configs/unet3d_train.yml from "
            "gzip HDF5 volumes")
        cfg_train = phase_config_train(SEED, workdir, step_ms)
        log(f"[phase 13] config-driven training ok; wall "
            f"{time.time() - t_phase:.1f} s")
        t_phase = time.time()
        log("[phase 14] cli/predict3d.py on configs/unet3d_predict.yml, "
            "phase 13's best checkpoint, to HDF5")
        cfg_predict = phase_config_predict(SEED, workdir, cfg_train["best"])
        log(f"[phase 14] config-driven prediction ok; wall "
            f"{time.time() - t_phase:.1f} s")
        t_phase = time.time()
        log("[phase 15] bf16 3D training: phase 9's configuration and "
            "bench.py's 3D rows; a bf16 predictor batch; kernel 2 in bf16")
        bf16 = phase_train_bf16(SEED, workdir, step_ms)
        log(f"[phase 15] bf16 3D ok; wall {time.time() - t_phase:.1f} s")
        t_phase = time.time()
        log("[phase 16] device_cache: bench.py's unet3d_e2e_train_device_cache"
            " through create_trainer(...).fit(), against the host loader")
        dcache = phase_device_cache(SEED, workdir)
        log(f"[phase 16] device_cache ok; wall {time.time() - t_phase:.1f} s")
        t_phase = time.time()
        log("[phase 17] ResidualUNetSE3D, UNet3D 'bcr', UNet2D, "
            "ResidualUNet2D; remat on phase 9's configuration")
        family = phase_family_and_remat(SEED, workdir)
        log(f"[phase 17] family and remat ok; wall "
            f"{time.time() - t_phase:.1f} s")
        t_phase = time.time()
        log("[phase 18] int8 PTQ: bench.py's int8 row, predict3d with "
            "quantize: int8, the trained-model fidelity leg, int8 serving, "
            "the int8 conv against its plain version at every shape")
        int8 = phase_int8(SEED, workdir)
        log(f"[phase 18] int8 ok; wall {time.time() - t_phase:.1f} s")
        t_phase = time.time()
        log("[phase 19] export: phase 2's UNet with a symbolic batch, "
            "served through register_exported; phase 3's UNet3D and phase "
            "4's ResidualUNet3D at their padded patch")
        exported = phase_export(SEED, workdir)
        log(f"[phase 19] export ok; wall {time.time() - t_phase:.1f} s")
        t_phase = time.time()
        log("[phase 20] SAM-Med2D at the JAX defaults through register_sam")
        sam = phase_sam(SEED, workdir)
        log(f"[phase 20] SAM ok; wall {time.time() - t_phase:.1f} s")
        t_phase = time.time()
        log("[phase 21] LazyPredictor over LazyHDF5Dataset, DSB2018 "
            "prediction, train3d with NAdam and an instance metric, the new "
            "optimizers card vs CPU")
        rest = phase_pipeline_rest(SEED, workdir, cfg_train, cfg_predict)
        log(f"[phase 21] ok; wall {time.time() - t_phase:.1f} s")
        t_phase = time.time()
        log("[phase 23] data parallel: DDP over NCCL in a world of 1, two "
            "ranks over gloo on the card, dist_ckpt resume, the profiler "
            "tooling")
        dp = phase_data_parallel(SEED, workdir)
        log(f"[phase 23] ok; wall {time.time() - t_phase:.1f} s")
        t_phase = time.time()
        log("[phase 24] spatially sharded training: windowed kernels 3a and "
            "3d, spatial_sharded_apply and make_spatial_train_step in a "
            "world of 1 over NCCL and two ranks over gloo, train3d with the "
            "parallel: keys")
        spatial = phase_spatial(SEED, workdir, step_ms)
        log(f"[phase 24] ok; wall {time.time() - t_phase:.1f} s")
        t_phase = time.time()
        log("[phase 25] the model axis: kernels 1 and 2 at the tensor-"
            "parallel shapes; TP of phase 9's UNet3D and phase 11's UNet on "
            "two ranks; ZeRO-1 against DDP; TP + ZeRO-1 on four ranks with "
            "a sharded checkpoint resumed")
        mp = phase_model_axis(SEED, workdir, train_shapes)
        log(f"[phase 25] ok; wall {time.time() - t_phase:.1f} s")
        t_phase = time.time()
        log("[phase 26] file formats: the HDF5 and PNG fixtures against "
            "their manifest; predict3d over a libver='latest' volume and "
            "its v0 copy; LazyPredictor's memo appended to the latest file; "
            "DSB2018 over palette, sub-byte, 16-bit colour and interlaced "
            "PNGs")
        formats = phase_read_formats(SEED, workdir)
        log(f"[phase 26] ok; wall {time.time() - t_phase:.1f} s ({smi})")
        t_phase = time.time()
        log("[phase 27] TIFF, GIF and BMP: the fixtures against their "
            "manifest; DRIVE-sized files served beside PNG twins; a DRIVE "
            "directory of TIFF images and GIF manuals through "
            "cli/train2d.py; DSB2018 over TIFF, GIF and BMP")
        images27 = phase_image_formats(SEED, workdir)
        log(f"[phase 27] ok; wall {time.time() - t_phase:.1f} s ({smi})")
        t_phase = time.time()
        log("[phase 28] JPEG: the fixtures against their manifest; "
            "DRIVE-sized JPEGs served beside PNG twins; a DRIVE directory of "
            "JPEG images and manuals through cli/train2d.py; DSB2018 over "
            "JPEG")
        images28 = phase_jpeg(SEED, workdir)
        log(f"[phase 28] ok; wall {time.time() - t_phase:.1f} s ({smi})")
        t_phase = time.time()
        log("[phase 29] orbax: the fixtures against their manifest and the "
            "zstd decoder's rate; the JAX package's TP and ZeRO-1 "
            "checkpoints resumed by cli/train3d.py; the TP one by two gloo "
            "ranks with TP and with ZeRO-1")
        orbax = phase_orbax(SEED, workdir)
        log(f"[phase 29] ok; wall {time.time() - t_phase:.1f} s ({smi})")
        t_phase = time.time()
        log("[phase 30] the HDF5 files of ROADMAP item 20: the fixtures "
            "against their manifest; predict3d over the phantom as a VDS, "
            "through an external link, with szip and as n-bit 12-bit "
            "samples; LazyPredictor's memo appended to the VDS file; the "
            "szip decoder's rate")
        item20 = phase_item20_files(SEED, workdir)
        log(f"[phase 30] ok; wall {time.time() - t_phase:.1f} s ({smi})")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if train2d["launches"] == 0:
        raise AssertionError("double_conv2d was never launched in training")

    # launches of each kernel over the main-path runs it belongs to (each
    # run zeroes the counts just before and reads them just after)
    def summed(*rs):
        return {k: sum(r[k] for r in rs) for k in KERNELS_3D}

    new_paths = {
        "train_3d_bf16": summed(*({k: sum(v.values()) for k, v in r.items()}
                                  for r in bf16["launches"].values())),
        "predict_3d_bf16": bf16["predict"]["launches"],
        "device_cache": dcache["launches"],
        "remat": family["launches"]["remat"],
        "export_3d": summed(*(r["launches"] for r in
                              exported["3d"].values())),
        "se3d": family["launches"]["ResidualUNetSE3D"],
        "unet2d_3dfamily": summed(family["launches"]["UNet2D"],
                                  family["launches"]["ResidualUNet2D"]),
        **int8["counts"],
        **rest["launches"],
        **{k: v for k, v in dp["launches"].items() if k != "dp_2d_ddp"},
        **spatial["launches"],
        **mp["launches"],
        **formats["launches"],
        **images27["launches"],
        **images28["launches"],
        "orbax_resume": orbax["launches"],
        **item20["launches"],
    }
    runs = (unet3d_launches, res_launches, serve3d_launches, train_launches,
            res_train_launches, cfg_train["launches"],
            cfg_predict["launches"], *new_paths.values())
    launches_3d = summed(*runs)
    for k, n in launches_3d.items():
        if n == 0:
            raise AssertionError(f"{k} was never launched on the main path")
    log(f"3D main-path launches: UNet3D predictor {unet3d_launches}, "
        f"ResidualUNet3D predictor {res_launches}, 3D serving "
        f"{serve3d_launches}, UNet3D training {train_launches}, "
        f"ResidualUNet3D training {res_train_launches}; averaged-map errors "
        f"{unet3d_err:.3e} (UNet3D), {res_err:.3e} (ResidualUNet3D); worst "
        f"autograd gradient error {grad_err:.3e}; UNet3D train step "
        f"{step_ms:.1f} ms kernel path, {plain_step_ms:.1f} ms plain path, "
        f"peak {peak:.2f} GiB; config-driven train3d {cfg_train['launches']}"
        f" (device step {cfg_train['step_ms']:.1f} ms, loader wait "
        f"{cfg_train['wait_ms']:.1f} ms), predict3d "
        f"{cfg_predict['launches']} ({cfg_predict['wall_s']:.2f} s, map "
        f"vs plain {cfg_predict['err']:.3e})")

    sources = {"gcr_conv3d": "gcr_conv3d.cu", "gn_stats": "group_norm.cu",
               "gn_affine": "group_norm.cu", "gn_bwd_reduce": "group_norm.cu",
               "gn_bwd_dx": "group_norm.cu", "overlap_add": "overlap_add.cu"}
    replaces = {"gcr_conv3d": "ops/fused_conv.py:244",
                "gn_stats": "ops/norm.py:360", "gn_affine": "ops/norm.py:375",
                "gn_bwd_reduce": "ops/norm.py:382",
                "gn_bwd_dx": "ops/norm.py:399",
                "overlap_add": "ops/overlap.py:100"}
    log(f"2D training: kernel-1 launches {train2d['launches']} (serving "
        f"{launches}); step {train2d['steady']:.2f} ms kernel path, "
        f"{train2d['plain_steady']:.2f} ms plain path; peak "
        f"{train2d['peak']:.2f} / {train2d['plain_peak']:.2f} GiB; "
        f"kernel-vs-plain loss gaps {train2d['gaps']}")
    log(f"UNet-3+ (launches none of the seven kernels): "
        + "; ".join(f"{k} {v['step_ms']:.2f} ms a step, "
                    f"{v['images_per_s']:.2f} images/s, peak "
                    f"{v['peak_gib']:.2f} GiB"
                    for k, v in u3p.items() if k.startswith("remat "))
        + f"; remat on/off loss gaps {u3p['remat_gaps']}; card vs CPU "
        f"{u3p['cpu_gaps']}; served p50 {u3p['serve_unet3plus_p50_ms']:.1f}"
        f" / {u3p['serve_cgm_p50_ms']:.1f} ms (UNet_3Plus / CGM); {smi}")
    export_2d = (sum(exported["2d"]["launches_per_batch"].values())
                 + exported["2d"]["served_launches"])
    log(f"export (phase 19, {smi}): {json.dumps(exported)}")
    log(f"SAM (phase 20, {smi}): {json.dumps(sam)}")
    log(f"pipeline rest (phase 21, {smi}): {json.dumps(rest)}")
    dp_2d = dp["launches"]["dp_2d_ddp"]
    log(f"data parallel (phase 23, {smi}): {json.dumps(dp)}")
    log(f"spatial (phase 24, {smi}): {json.dumps(spatial)}")
    log(f"model axis (phase 25, {smi}): {json.dumps(mp)}")
    log(f"file formats (phase 26, {smi}): {json.dumps(formats)}")
    log(f"image formats (phase 27, {smi}): {json.dumps(images27)}")
    log(f"JPEG (phase 28, {smi}): {json.dumps(images28)}")
    log(f"orbax (phase 29, {smi}): {json.dumps(orbax)}")
    log(f"item-20 HDF5 files (phase 30, {smi}): {json.dumps(item20)}")
    k1_formats = {**images27["kernel1"], **images28["kernel1"]}
    kernels = [{
        "name": "double_conv2d",
        "route": "cuda",
        "source": "mdeical_image_segmentation_tpu_torch/csrc/double_conv2d.cu",
        "replaces": "mdeical_image_segmentation_tpu/ops/fused_conv.py:420",
        # served batches (phase 2), Trainer.train() (phase 11), the
        # exported artifact (phase 19), Trainer.train() under DDP (23), and
        # TIFF, GIF and BMP (27) and JPEG (28) served and DRIVE trained from
        # them
        "launches": (launches + train2d["launches"] + export_2d + dp_2d
                     + sum(k1_formats.values())),
        "launches_by_path": {"serve_2d": launches,
                             "train_2d": train2d["launches"],
                             "export_2d": export_2d, "dp_2d_ddp": dp_2d,
                             **k1_formats},
        "max_abs_err": max(max_err, dc_train["max_abs_err"]),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": dc_bound,
        "bound_by": "operations",
        # the plain version is the library's: two cuDNN conv2d + relu
        "library_ms": plain_ms,
        "device_ms": None,
        # the 9 shapes at the training batch (N=32, bf16, z written)
        "train": {k: (None if isinstance(v, float) and math.isnan(v) else v)
                  for k, v in dc_train.items()},
    }] + [{
        "name": k,
        "route": "cuda",
        "source": f"mdeical_image_segmentation_tpu_torch/csrc/{sources[k]}",
        "replaces": f"mdeical_image_segmentation_tpu/{replaces[k]}",
        "launches": launches_3d[k],
        "launches_by_path": {"config_train3d": cfg_train["launches"][k],
                             "config_predict3d": cfg_predict["launches"][k],
                             **{path: n[k] for path, n in new_paths.items()}},
        "max_abs_err": k3d[k]["err"],
        "ms": k3d[k]["ms"],
        "plain_ms": k3d[k]["plain_ms"],
        "bound_ms": k3d[k]["bound_ms"],
        "bound_by": ("operations" if k3d[k]["op_ms"] >= k3d[k]["byte_ms"]
                     else "bytes"),
        "library_ms": k3d[k]["library_ms"],
        # torch.profiler's device time over the same shapes, where measured
        "device_ms": (None if k3d[k]["device_ms"] is None
                      or math.isnan(k3d[k]["device_ms"])
                      else k3d[k]["device_ms"]),
        # 3a and 3d with the interior window at phase 24's slab shapes
        **({"window": spatial["window"][k]} if k in spatial["window"]
           else {}),
        # kernel 2 at the UNet3D training shapes with Co/2 (phase 25 (e))
        **({"tp": _tp_k2(mp)} if k == "gcr_conv3d" else {}),
    } for k in KERNELS_3D]
    kernels.insert(1, _single_conv_row(mp))
    k2 = bf16["k2"]
    bf16_k2_launches = (bf16["by_dtype"]["gcr_conv3d"]["bfloat16"]
                        + bf16["predict"]["by_dtype"]["gcr_conv3d"]["bfloat16"])
    if bf16_k2_launches == 0:
        raise AssertionError("kernel 2 never ran in bf16 on a model path")
    kernels.append({
        "name": "gcr_conv3d_bf16",
        "route": "cuda",
        "source": "mdeical_image_segmentation_tpu_torch/csrc/gcr_conv3d.cu",
        "replaces": f"mdeical_image_segmentation_tpu/{replaces['gcr_conv3d']}",
        # kernel 2's bf16 launches on the bf16 paths of phase 15
        "launches": bf16_k2_launches,
        "launches_by_path": {
            "train_3d_bf16": bf16["by_dtype"]["gcr_conv3d"]["bfloat16"],
            "predict_3d_bf16":
                bf16["predict"]["by_dtype"]["gcr_conv3d"]["bfloat16"]},
        "max_abs_err": k2["err"],
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": ("operations" if k2["op_ms"] >= k2["byte_ms"]
                     else "bytes"),
        # cuDNN's bf16 conv3d alone, on the same inputs, without the affine
        "library_ms": k2["library_ms"],
        # torch.profiler's device time over the same shapes
        "device_ms": (None if math.isnan(k2["device_ms"])
                      else k2["device_ms"]),
    })
    log("bf16 3D (phase 15): " + "; ".join(
        f"{k} {v['step_ms']:.1f} ms a step, {v['patches_per_s']:.2f} "
        f"patches/s, peak {v['peak_gib']:.2f} GiB (plain "
        f"{v['plain_step_ms']:.1f} ms)" for k, v in bf16["runs"].items())
        + f"; fp32 phase 9 {bf16['fp32_step_ms']:.1f} ms; predictor batch "
        f"{bf16['predict']['ms']:.1f} ms (fp32 {bf16['predict']['fp32_ms']:.1f})"
        f"; launches by dtype {bf16['by_dtype']}")
    log("device_cache (phase 16): " + "; ".join(
        f"{k} {dcache[k]['ms_per_step']:.1f} ms a step, "
        f"{dcache[k]['patches_per_s']:.2f} patches/s, wait median "
        f"{dcache[k]['wait_ms']:.2f} ms" for k in ("device_cache",
                                                   "host_loader"))
        + f"; cache {dcache['device_cache']['nbytes'] / 2**20:.1f} MiB")
    log("family and remat (phase 17): " + "; ".join(
        f"{k} {v['step_ms']:.1f} ms a step (plain {v['plain_step_ms']:.1f}), "
        f"peak {v['peak_gib']:.2f} GiB" for k, v in family["runs"].items())
        + "; remat " + "; ".join(
            f"{k} {v['ms']:.1f} ms, peak {v['peak_gib']:.2f} GiB"
            for k, v in family["remat"].items()))
    log(f"int8 (phase 18): {json.dumps({k: v for k, v in int8.items() if k not in ('sums', 'counts')})}")
    if int8["launches"] == 0:
        raise AssertionError("int8_conv was never launched on the main path")
    kernels.extend(_int8_kernel_rows(int8))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
