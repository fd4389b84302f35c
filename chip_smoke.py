#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``gnot_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card's name and power limit (``nvidia-smi``);
2. every kernel under ``gnot_tpu_torch/csrc`` built for sm_90a, one
   ``nvcc`` per source started together, with the ``-Xptxas -v``
   register / shared-memory report and a line per source with each
   kernel instance's registers and the bytes spilled, and the count of
   tensor-core instructions in the SASS (``cuobjdump``) of the FFN
   library (``HGMMA``) and of the reduce library (``HMMA``), each of
   which must be above 0;
3. the FFN kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it and at a ragged row count, for both
   GELUs, with the kernel's device time (``torch.profiler``; CUDA events
   over back-to-back calls beside it, which include the host's enqueue)
   beside its 3xTF32 tensor-core bound (and the earlier f32 CUDA-core
   bound), the plain version's and, as the yardstick, that of the
   model's ``ffn_impl="xla"`` torch path (batched cuBLAS f32 GEMMs) at
   the same shape; then the same kernel on the bf16 mix of bf16 serving
   (bf16 x, weights and biases, f32 scores) against its plain version
   within one bf16 ulp, timed beside the f32 kernel and the
   ``ffn_impl="xla"`` path in bf16 (cuBLAS bf16 GEMMs); then the bf16
   training mix (bf16 x, f32 weights and biases, f32 scores), bitwise the
   f32 instance on the widened x rounded once to bf16 and within one bf16
   ulp of its plain version, both GELUs, timed beside its bound;
3b. the kernel-validation entry point (``gnot_tpu_torch.validate_kernels``)
   in-process, every launch count set to 0 just before it and read just
   after: each attention kernel and the FFN kernel against its plain
   version, forward and gradients, at the JAX tool's shapes and at full
   width; then each attention kernel's device time (``torch.profiler``)
   at full width beside its bound and its plain version's (the reduce
   kernels beside two bounds, 3xTF32 on the tensor cores and f32 on the
   CUDA cores, and their max abs errors beside the f32 FFMA kernel's;
   the plain reduce with cuBLAS TF32 on, one TF32 product, must miss
   the kernels' bar at every full-width case), and the composed ops
   (``fused_nla``, ``fused_nla_packed``) beside the torch einsum paths
   the model runs;
4. the serving path at full width through ``gnot_tpu_torch.main``'s
   serve function with ``--ffn_impl pallas``: 16 NS2d-1k requests,
   ``max_batch=4``, every result ``ok``, the FFN kernel launched
   ``2 x n_attn_layers`` times per dispatch, each output held against a
   forward of the same weights with every FFN through the kernel's plain
   version;
4b. the same serving path in bf16 (``--serve_dtype bfloat16``): 16/16
   requests, every FFN launch at bf16, f32 outputs held against the same
   bf16 forward through the kernel's plain version and against phase 4's
   f32 server of the same weights, with the dispatch and request times,
   the device busy time of one bf16 and one f32 dispatch and the peak
   device memory;
5. where one full-width dispatch spends its time: host-clock dispatch
   time with the kernel and with the plain torch FFN path, in turns, and
   a ``torch.profiler`` trace of device time by kernel;
6. training at full width through ``gnot_tpu_torch.main``'s train
   function: ``--synthetic ns2d --n_train 16 --n_test 8 --epochs 2
   --batch_size 4 --ffn_impl pallas`` (8 AdamW steps, 4 eval batches),
   the reference's console lines with finite losses, the FFN kernel
   launched ``2 x n_attn_layers`` times per train and eval forward, the
   same run with every FFN through the plain version (no kernel launch)
   agreeing step by step, a stale-image control run (fused AdamW) read
   against it, the kernel agreeing with the plain version on the live
   weights after the optimizer's last step and after one more, host-clock
   step times with the kernel and with ``ffn_impl=xla`` in turns, and
   where one train step spends its time, phase by phase for both paths;
6b. the same training in bf16 (``--dtype bfloat16``, checkpoints kept
   under ``build/chip_smoke/``): the reference's lines, every FFN launch
   of the bf16 training mix, 8 per train step and eval forward, the run
   held step by step against the same run through the plain version (bar
   ``BF16_TRAIN_REL``), which must catch two controls (f32 training, and
   the serving instance on bf16-cast weights); the plain run again with
   cuBLAS's reduced-precision bf16 reduction off; host-clock step times,
   bf16 and f32, kernel and ``ffn_impl=xla``, in turns; peak memory;
6c. one epoch with ``--remat`` (16 launches a step, the losses of the
   same run without remat at rtol 1e-5, peak memory beside it), then
   ``--eval_only --predict_out --export_torch`` from phase 6b's
   checkpoints: the metric of phase 6b's best epoch, a prediction pickle
   that reads back, and the reference's names of the best weights;
7. parity training at full width: ``--synthetic darcy2d --attention_mode
   parity --n_train 16 --n_test 8 --epochs 2 --batch_size 4 --ffn_impl
   pallas`` (erf GELU, bucketing off, cuBLAS TF32 off): the reference's
   lines, every launch with the erf GELU, 8 per train and eval forward,
   held step by step against the plain-FFN run to phase 6's bars; then
   one ragged batch through the parity model with and without masks
   (equal) and through a masked model of the same weights (outside the
   model-level bar on every padded sample: the padding-pollution
   control);
8. packed serving at full width: ``--serve --serve_packed --synthetic
   elasticity`` (16 ragged requests, a ``PackPlan`` derived from them,
   chunk 64), f32 then ``--serve_dtype bfloat16``: 16/16 ``ok``, 8
   launches per packed dispatch, the plan and its real / capacity tokens,
   every f32 output against its solo padded dispatch (rtol 1e-5 atol
   1e-5), bf16 against f32 (``BF16_F32_REL``) and, on the same
   dispatches, against the plain version (``BF16_PLAIN_REL``, with phase
   4b's control); a packed forward finite in its pad tail; host-clock
   time of the 16 requests as packed and as padded dispatches, in turns;
   the kernel at the packed launch shape against its plain version, its
   device time beside its bound;
9. packed training at full width: ``--synthetic elasticity --packed
   --n_train 16 --n_test 8 --epochs 2 --batch_size 4 --ffn_impl pallas``:
   the reference's lines, 8 launches per step and eval forward, held
   step by step against the plain-FFN run to phase 6's bars, the final
   test metric within rtol 0.05 of the unpacked run of the same data,
   and host-clock step times packed and unpacked, in turns;
10. the rest of the training loop at full width, ``--synthetic ns2d
   --n_train 16 --n_test 8 --epochs 1 --batch_size 4 --ffn_impl pallas``
   (4 batches, 2 eval batches): (a) ``--grad_accum 2`` held step by step
   against the plain-FFN run to phase 6's bars, 8 launches per micro-step
   forward and eval forward, and every expert weight packed on the first
   micro-step after each update and on no other (``packed_weights.packs``
   per micro-step); (b) ``--steps_per_dispatch 4``: losses, test metric
   and every weight bitwise the K=1 run's, then host-clock step times of
   K=1 and K=4 in turns; (c) ``--flat_params`` held against the tree
   layout (the K=1 run) to phase 6's bars, saying whether it is bitwise,
   every weight 16-byte aligned, the CUDA kernels of one
   ``optimizer.step()`` flat and tree (``torch.profiler``), the
   stale-image control (the kernel against its plain version on the live
   weights after the last step and after one more), host-clock step
   times flat and tree in turns; (d) ``--scan_layers --ffn_impl xla``
   within rtol 1e-5 of the standard ``xla`` run, 0 kernel launches;
11. the observability plane at full width: phase 6's command with
   ``--telemetry --log_every 1 --metrics_path --trace_path --profile_dir``
   (under ``build/chip_smoke/obs/``) through the command line's run: every
   step record with every telemetry key, each ``gate_load/block_i``
   summing to 1, every record valid under ``obs/events.py``; one
   ``epoch`` trace per epoch with the train span tree and the "Wrote N
   spans" line; the profile of epoch 1 holding the FFN kernel's records, 8
   a step and eval forward; ``run.json`` naming the card; 96 launches
   (phase 6's count); step losses bitwise phase 6's; the telemetry held
   against the plain-FFN run of the same flags at phase 6's bars; the
   synchronizing calls torch reports over the steps between two drains,
   with and without telemetry, equal; waited-for step times without and
   with ``--telemetry --log_every 10`` in turns and the device busy share
   of one step of each; a poisoned sample raising ``FloatingPointError``
   at epoch 0 with one ``non_finite_loss`` record naming a module; phase
   4's serving traffic with ``--metrics_path --trace_path``: 16 whole
   request chains, ``queue_depth`` tokens adding up to the summary's, one
   valid ``serve_summary``, 2 x ``n_attn_layers`` launches a dispatch;
12. recovery, fault injection, graceful preemption and the checkpointer's
   fallback chain at phase 6's configuration through the command line's
   run (under ``build/chip_smoke/resil/``), the FFN kernel in every step
   and its launches derived from the steps each run dispatches: (a)
   ``--recovery --snapshot_every 2 --inject_fault nan_grad@3 --telemetry``,
   one ``rollback`` and one ``batch_quarantined`` event, the step losses
   bitwise those of a run whose epoch-0 loader drops the quarantined
   dispatch; (b) ``--max_rollbacks 0 --checkpoint_every 1 --inject_fault
   nan_grad@6``, a ``recovery_restore`` from ``latest.1.pt`` and a finite
   best metric; (c) ``stop_epoch@1`` then ``--resume``, both halves
   bitwise phase 6's epochs; (d) ``sigterm@3`` then ``--resume`` (a
   resumable ``preempt_save``) and ``corrupt_ckpt@1,stop_epoch@1`` then
   ``--resume`` (a ``restore_fallback`` naming the skipped file), both
   finite; (e) ``ckpt_io@2``, two ``io_retry`` events and every save
   committed; (f) the costs beside the card's name and power limit: one
   snapshot's device and host time against its byte bound, the async
   save's copy to page-locked memory, the synchronizing calls over one
   snapshot window (plain 0, ``--recovery`` 1, ``--debug_checks`` 2), the
   waited-for step time of each in turns, and the ``checkpoint_save``
   spans and one save's host time against a synchronous ``torch.save``.
13. the single server's failure handling, hot reload and live metrics at
   phase 4's configuration, on a checkpoint (``best`` and ``latest``)
   the phase trains itself with phase 6's configuration plus
   ``--telemetry --metrics_interval_s 0.05``, whose ``train_step_time_ms``
   series must hold one record per timed step: (a) ``slow_request@1``
   under a 150 ms deadline sheds exactly the victim's dispatch (no
   ``queue_depth`` for it), the other groups served within phase 4's
   bars; (b) ``nan_output@1,2`` trips the breaker (threshold 2),
   ``breaker_open``, ``rejected_breaker_open``, then ``breaker_close``
   after the 0.2 s cooldown, ``breaker_trips`` 1, no launch for the
   rejected request; (c1) four reloads on a server started on fresh
   weights, each followed by one group: 40 repacks per reload, on the
   dispatch after it, outputs bitwise a fresh engine's on the restored
   weights, the second reload under ``reload_corrupt`` (and the two
   after it, ``latest`` staying truncated) walking on to ``best``; (c2) ``main --serve_reload_every 4`` with (e) the metrics
   plane (``--metrics_interval_s 0.05 --slo_p99_ms 1``): 16/16 ok, four
   ``ok`` reloads, snapshots, the series and exposition files, a
   ``latency_p99`` fire and ``summary_agrees``; (c3) the same with
   ``reload_corrupt@2``; (c4) ``--serve_dtype bfloat16`` with one reload,
   and a bf16 server's reload publishing bf16 weights within phase 4b's
   bars; (d) SIGTERM sent at the sixth submit through ``main``: the storm
   stops, the six complete, one ``serve_summary``; (f) the costs: a
   dispatch's kernel launch calls and synchronizing calls with the
   deadline, breaker and registry on and off (must be equal), a reload's
   device and host time and the repack on the dispatch after it, and a
   64-request storm's dispatch times with and without the publisher.
14. rollout sessions and tenants at phase 4's configuration: (a) ``main
   --serve_rollout_steps 8 --session_snapshot_every 2`` with the metrics
   plane, 16 sessions x 8 steps all complete, ``rollout_steps_total``
   128, 8 FFN launches a dispatch, each served trajectory within 1e-5 of
   ``offline_rollout`` on the same engine with the rows pinned to 4
   (bitwise or not, printed); (b) the same through ``--ffn_impl xla`` (no
   launch), step 1 held to the model bar and the worst difference of
   each step printed; (c) ``--serve_dtype bfloat16`` held to the bf16
   ``offline_rollout``; (d) ``rollout_nan@3``, ``stale_session@5`` and
   ``replica_kill@9`` on a standalone server, each with its reasons,
   lost sessions and launches; (e) SIGTERM mid-rollout under a session
   store, every session ``drained`` after its snapshot was persisted, then
   resumed on a fresh engine to the uninterrupted trajectory; (f) a tenant
   storm (weights 3:1, ``batch`` quota 4, 48 requests, ``batch`` at 3x
   ``interactive``, 4 ``interactive`` sessions) with no ``interactive``
   shed, a ``tenant_quota_shed`` per quota shed, the ``tenants`` block,
   ``summary_agrees`` and ``slo_alert`` edges naming a tenant; (g) the
   costs: a step's host work, a dispatch's kernel launch calls and
   synchronizing calls with sessions and with one-shot requests (must be
   equal), step against one-shot latency, and a rollout storm's device
   busy share.
15. engine replicas and the router at phase 4's configuration, two
   replicas sharing the card, each on its own CUDA stream: (a) ``main
   --serve --serve_replicas 2`` in f32 (under ``torch.profiler``) and in
   bf16, 16/16, one ``route`` event a request, both replicas serving,
   the FFN kernel launched ``2 x n_attn_layers`` times per dispatch and
   warm-up summed over both, the outputs held to the plain forward (f32
   at the model bar, bf16 at phase 4b's), the kernel's records on two
   stream ids apart from a control launch's on the default stream; (b)
   one replica against two under the same 64-request storm, in turns
   (1, 2, 2, 1): wall time, device busy (kernel union) share, p50 / p99,
   dispatches and a dispatch's host time per replica, kernel launch calls
   and synchronizing calls a dispatch, and how long the two streams'
   kernels overlapped (recorded, not a threshold); (c) a rolling reload
   under four closed-loop clients with ``reload_corrupt`` on replica 1:
   no shed, one replica warming at a time, replica 1 bitwise its outputs
   before, replica 0 on the new weights; (d) ``replica_kill`` in the
   middle of four 8-step sessions: the orphans migrate from their
   snapshots, none lost, every trajectory bitwise ``offline_rollout`` on
   the sibling's engine; (e) ``nan_output`` on replica 0 under a
   threshold-1 breaker: the next requests on replica 1, then the trial
   closes the breaker; (f) ``remove_replica`` mid-rollout (``scale_in``
   handovers with no replay) and ``add_replica`` of a warmed replica,
   which takes traffic.
16. the program catalog and the autoscaler at phase 4's configuration:
   (a) phase 4's 16 requests through a single server and through two
   replicas, each with a ``ProgramCatalog``, in f32, in bf16 and packed
   (phase 8's plan derivation over this traffic): one
   ``program_catalog`` event a program with the costs of
   ``obs/costs.py::program_costs`` at its shape, one
   ``capacity_snapshot``, per program the dispatches and the useful-token
   fraction of the pad-waste rollup, every achieved ``flops_per_s``
   below the card's peak for the program (bf16: the bf16 dense peak;
   f32: its FFN Linears at 3xTF32 and its other products at the f32
   CUDA-core peak, weighted by its flops), printed per program beside
   ``tokens_per_device_s`` and ``device_us_per_token``; (b) ``main
   --serve --serve_replicas 1 --autoscale --autoscale_max 3`` with a
   20 ms tick and a 0.1 s cooldown under a ramp (eight closed-loop
   clients, 96 requests, then quiet): a ``scale_up`` whose replica warmed
   before its first route, no shed, a ``scale_down`` back to one replica,
   96/96 within phase 4's bar, launches 8 x (dispatches + warm-ups) over
   every replica that served; (c) ``replica_kill@5`` in a two-replica
   elastic pool under four 8-step sessions and four closed-loop clients:
   one ``replica_replace`` 0 -> 2 on slot 0 within ``heal_after_s`` plus
   a tick, no session lost, every trajectory bitwise ``offline_rollout``;
   (d) (b)'s ramp through a static pool of three replicas, its
   replica-seconds and p99 beside the controller's (printed, no bar).
17. the federation at phase 4's configuration, ``main --serve
   --serve_replicas 2 --hosts 2`` (two loopback hosts of one replica
   each, a ``ClusterRouter`` over the wire protocol): (a) in-proc links in
   f32: 16/16 within phase 4's bar of a forward through the kernel's
   plain version, ``hosts_dead`` and ``protocol_errors`` 0, one
   ``cluster_summary``, launches 8 x (dispatches + warm-ups) summed over
   the hosts, all f32; its latency beside one router over two replicas
   and the largest frames beside ``MAX_FRAME_BYTES``; (b) the same over
   loopback TCP (``--federation_port``), its wall beside (a)'s; (c) bf16
   within phase 4b's bar, bf16 launches only, with the merged cluster
   trace: three sources and one stitched chain a request (``placement``,
   ``cluster_request``, a host's serve spans); (d) 8-step sessions with a
   session store and ``host_kill@12`` under 0.1 / 0.2 / 0.4 s leases: one
   ``host_dead``, a ``session_remigrate`` for each of its sessions, none
   lost, every trajectory bitwise ``offline_rollout``, and the host time
   of one ``SessionStore.save``; (e) (d) traced at rate 1 with the flight
   recorders: the merged trace's sources the controller and the
   survivor, each re-migrated session's resumed steps in its original
   trace, one controller ring dumped on ``host_dead``.
18. parallel training over ``torch.distributed``, its ranks as processes
   of this script (``--rank``) or of ``torchrun``, each with its own
   deadline: (b) ``torchrun --nproc_per_node 1 -m gnot_tpu_torch.main
   --distributed`` at phase 6's flags with ``--ffn_impl xla`` (a mesh of
   one on NCCL) against the run without ``--distributed`` (max rel diff at
   most 1e-5), the two at once beside (d)'s resume, last; (a) ``fused_nla_sp`` at q
   ``[4,1024,256]``, H=8, cross k/v ``[1,4,512,256]`` and self, on 2 ranks
   sharing the card (gloo with CUDA tensors), psum and ring, each rank
   launching the reduce and apply kernels once a forward, the ranks'
   blocks and gradient parts within 1e-5 / 1e-6 of ``fused_nla`` and of
   ``reference_impl``, and a world of one bitwise ``fused_nla``; (c) the
   same flags on 2 ranks with ``--mesh_data 2``, ``--mesh_seq 2`` and
   ``--mesh_model 2`` and on 3 with ``--mesh_expert 3``, within 1e-5 of
   (b), with each rank's step time, all-reduce calls and time a step
   (``torch.profiler``) and peak memory, and the model and expert runs'
   gathered best checkpoints evaluating on one device to their runs' best
   metrics; (d) ``--mesh_seq 2`` with SIGTERM to rank 1 alone: both ranks
   stop after step 3 and rank 0 saves ``latest``; ``--resume`` in a fresh
   launch ends bitwise where the stopped run carried on in memory ends.
19. the rest of parallel training at phase 18's flags, ranks sharing the
   card (gloo with CUDA tensors): (a) the pipeline schedule, ``--mesh_pipe
   2`` on 2 ranks (2 blocks a stage, M = 2) and ``--mesh_pipe 4
   --microbatches 4`` on 4 (1 block a stage), and (b) ``--mesh_model 2
   --mesh_pipe 2`` on 4, each within 1e-5 of phase 18 (b)'s mesh of one;
   (c) ``--packed --mesh_data 2`` on 2 within 1e-5 of the single-device
   packed run of phase 9's flags (``--ffn_impl xla``); (d) ``--scan_layers
   --mesh_data 2 --mesh_model 2`` on 4 within 1e-5 of a single-device
   ``--scan_layers`` run; per rank of (a)-(d) the step time, the stage
   hops' calls and host ms a step with the share spent waiting on gloo,
   the bubble ``(S-1)/(M+S-1)`` and peak memory, and 0 FFN and attention
   kernel launches (both packages refuse kernels on a mesh); (e)
   ``--mesh_pipe 2`` with SIGTERM to rank 1 alone: both stop after step 3,
   and ``--resume`` in a fresh launch (beside the single-device
   references of (c) and (d)) ends bitwise where the stopped run carried
   on in memory ends.
20. the native host packer (``gnot_tpu_torch/native``, built with g++ on
   this host at first use): (a) ``status()`` native, then each C symbol
   above its bar (f32 ``pack_rows`` at 48 MiB and up, the threaded sweep;
   bf16 ``pack_rows`` at 128 KiB; ``unpad_rows`` at 8 MiB and up) called
   once, counted by wrapping the dlopen handles' functions from this
   script, bitwise its numpy version; each symbol native against numpy
   at payloads around its bar, in turns, with this host's crossover;
   (b) ``main --serve --serve_dtype bfloat16 --synthetic ns2d --n_test 32
   --serve_max_batch 16``: 32/32 ok, one fused pad-and-cast call for each
   field over the bf16 bar in every dispatch, 8 FFN launches a dispatch,
   the ``native_packer`` event and ``run.json``'s ``native_packer`` and
   ``serve_dtype``, outputs within phase 4b's bar of the plain-FFN forward
   and bitwise the same run with the native path off (the module's bars
   raised), and a 16-row dispatch's host phases both ways in turns; (c)
   phase 4's f32 serving with the event, 16/16 within phase 4's bar; (d)
   ``python -m gnot_tpu_torch.analysis`` exits 0.
21. serving over a rank mesh and parity on a mesh, at phase 4's and
   phase 7's flags with ``--ffn_impl xla`` (both packages refuse the FFN
   kernel on a mesh): (b) first, ``--serve --distributed`` with two nodes
   (``node_count`` patched), with ``--serve_replicas 2`` and with
   ``--autoscale`` raise JAX's ValueErrors before any rank exists; then
   one launch of 2 ranks sharing the card (gloo with CUDA tensors): (a)
   ``main --serve --distributed`` on ``--mesh_data 2``, ``--mesh_model 2``
   and ``--mesh_seq 2``, 16/16 each within rtol 1e-4 / atol 1e-5 of the
   single-device ``--serve --ffn_impl xla`` run, bf16 on the data mesh
   within phase 4b's bf16-vs-f32 bar, a hot reload mid-stream (best A
   served first, latest B = A x 0.9 reloaded after the 8th request:
   requests 9-16 within the bar of B's single-device outputs), and a
   SIGTERM to rank 0 at its third request (both ranks exit 0); per run a
   dispatch's host p50, its broadcast, forward and gather ms on rank 0,
   the follower's receive and forward ms, the weight ops' ms, peak memory;
   (c) ``--attention_mode parity`` training on ``--mesh_model 2`` and on
   ``--mesh_seq 2`` (bucketing kept on, as the API's default: the command
   line turns it off in parity mode, and JAX refuses seq > 1 then), each
   within 1e-5 of its single-device parity run, with the step time and
   the merge's all-gathers and their host ms a step; (d) ``python -m
   gnot_tpu_torch.analysis --changed`` exits 0.
22. the serving operator's tools on the card host
   (``gnot_tpu_torch/tools/``): (a) phase 4's serving through ``main
   --serve --ffn_impl pallas`` with ``--trace_path``, ``--metrics_path``
   and ``--metrics_interval_s 0.05`` and a ``ProgramCatalog`` on the
   server (as phase 16 attaches one): 16/16 within phase 4's bars, 8 FFN
   launches a dispatch, warm-ups included, and the final snapshot agreeing
   with the summary; (b) the readers on (a)'s files, each in a process
   where importing ``jax``, ``flax`` or ``gnot_tpu`` raises (and none was
   tried): ``trace_report`` with 16 ``queue_wait`` and 16 ``device`` spans
   and a request's critical path, ``metrics_report`` exiting 0 with its
   final-snapshot cross-check agreeing, and the capacity fold of the
   ``serve_summary`` event with no agreement problem; (c) ``serve_smoke``
   on the card in its default mode and with ``--replicas 2``,
   ``--rollout``, ``--tenants``, ``--hosts 2``, ``--capacity`` and
   ``--trace_path``, each ending with no failure; (d) each reader's host
   ms and each smoke mode's wall time beside the card's name and power
   limit.
23. training at the reference's own scale and at long context, and the
   attention kernels' bf16 instances: (a) ``gnot_tpu_torch.tools.
   reference_scale_demo``'s ``generate(16, 4)`` (9.5-10.5k-point meshes,
   760-850-point functions) under ``build/chip_smoke/ref_scale23/`` and its
   ``train`` for 2 epochs with JAX's argv on the card: a summary record
   with JAX's keys, finite losses, 0 FFN launches (``ffn_impl=xla``); (b)
   the same pickles through ``main --train_data/--test_data --dtype
   bfloat16 --steps_per_dispatch 5 --epochs 2 --ffn_impl pallas``: every
   FFN launch at x ``[4, 12288, 256]`` in the training mix, 8 per train
   step and eval forward, held step by step against the plain-FFN run (bar
   ``BF16_TRAIN_REL``), the kernel against its plain version on the live
   weights at that shape, host-clock step times with the kernel and with
   ``ffn_impl=xla`` in turns, peak device memory; (c) ``--synthetic
   heatsink3d --remat --dtype bfloat16 --ffn_impl pallas --n_train 4
   --n_test 2 --epochs 1`` at ``--synth_size 16384 --batch_size 2`` and
   ``65536 --batch_size 1``: finite losses, 16 launches a train step and 8
   an eval forward, the launch shapes those of the loaders' batches, the
   kernel against its plain version on the live weights at the largest,
   then 64k without ``--remat`` for its peak memory beside the remat run's;
   (d) ``validate_kernels.check_bf16`` at the four full-width cases: the
   reduce pair on bf16 k, v and mask at ``OUT_TOL`` and bitwise the launch
   on the widened inputs, the apply pair's bf16 ``out`` and ``qs`` within
   one bf16 ulp, gradients through the plain backward; (e) device time
   against the bound: the FFN kernel in the training mix at x ``[4, 12288,
   256]``, ``[2, 24576, 256]`` and ``[1, 98304, 256]`` with its CTAs and
   waves, and each attention kernel's bf16 instance beside phase 3b's f32
   time, its bound counting bf16 bytes;
24. the train-step bench (``python -m gnot_tpu_torch.bench``) and the three
   tools built on it, each run failing the phase with a ``[bench] <run>:``
   error; every run at windows of 5 and 20 steps, best of 2, with
   ``--mem_stats`` and no CPU baseline unless it says otherwise: (a)
   NS2d-1k in bf16 and f32 through ``--ffn_impl xla`` and ``pallas``, in
   this process: JAX's JSON keys, ``scan_marginal``, a non-null ``mfu``,
   one ``flops_per_step`` for both FFN paths, 8 FFN launches for each step
   run through the kernel (75 a run), and an f32 step from one state
   through either path after the windows' restore bitwise its first, the
   kernel's within ``MODEL_RTOL`` of ``xla``'s; (b) ``--timing persstep``
   within ``PERSSTEP_RATIO`` of (a)'s marginal; (c) darcy2d, elasticity,
   inductor2d and heatsink3d; (d) ``--packed`` at ``pack_ab``'s train size
   and ``--flat_params``; (e) ``--n_points 12288`` through ``xla`` and the
   kernel; (f) the f32 CPU baseline of one step, the entry point run
   without JAX; (g) ``honest_probe``, ``profile_step`` without JAX (its
   top kernel families, the records CUPTI kept against the launches) and
   ``pack_ab`` with its numerics bar (``PACK_AB_BAR``);
25. the seven overhead and chaos A/B tools, the phase failing with an
   ``[ab] <tool>:`` error that names the run: (a) each of ``telemetry_ab``,
   ``tracing_ab``, ``metrics_ab``, ``capacity_ab``, ``dtrace_ab``,
   ``rollout_ab`` and ``federation_ab`` with ``--device cuda`` at its
   argv in ``AB_TOOLS``, in a process of its own where JAX cannot be
   imported (the seven start together and wait, imported, at a gate; each
   runs alone once released): JAX's arm and summary names, ``platform`` "gpu", the summary
   arithmetic, and the correctness bars (the chaos A/Bs' ``failures`` empty:
   no session lost with migration or failover, some lost by each twin, at
   least one re-migrated, parity within 1e-5, the single-host pin
   byte-identical; publisher snapshots >= 1, attributed dispatches > 0);
   the 2% overhead bars are only reported; (b) ``telemetry_ab``'s and
   ``tracing_ab``'s windows on the reference-default model through the FFN
   kernel (NS2d-1k, batch 4, f32), both arms interleaved, best of 2,
   windows of 10 steps, 8 kernel launches a step counted over every
   warm-up and timed step; (c) the phase's seconds;
26. the open-loop serving load tools, each failure an ``[ab] <tool>:``
   error: (a) ``serve_bench``, ``lowprec_ab``, ``tenant_ab`` and
   ``autoscale_ab`` at ``--quick --device cuda``, each through its
   ``run()`` in a process of its own where JAX cannot be imported, started
   together and released one at a time after all four reached their gates,
   and ``loadgen`` in a process of its own (its traces for one seed
   bitwise the digest of the CPU, where the tests hold them to
   ``tools/loadgen.py``; every ``serve_bench`` run's arrivals recomputed).
   Asserted: the correctness bars (replicated vs solo and the parity within
   their bars, no interactive shed and the tenant rollup, the quota sheds
   and the default-path pin, no lost session or request in the chaos
   scale-in, a scale-out), and no entry in ``failures`` besides a capacity
   bar. Reported with a verdict: the capacity bars of each ``main``
   (sustained rates, a p99 under an SLO set from one idle dispatch, saved
   replica-seconds, the native packer's gain, ``serve_bench``'s 2.5x
   ``bar_speedup``, a bar for N devices): the replicas are threads sharing
   this one card and its host, each one's dispatch stretched by the others. (b) open-loop serving at full width through the FFN
   kernel: ``serve_bench``'s ``make_replicas``, ``fresh_router``,
   ``run_arm`` and ``numerics_check`` on the reference-default model
   (``ffn_impl="pallas"``, f32, ``max_batch`` 4), 1 and 2 replicas at 0.6x
   and 2.4x the measured 1-replica capacity, windows of 2 s; 8 launches per
   dispatch and warm-up dispatch, every served output held to the plain
   forward at ``MODEL_RTOL`` / ``MODEL_ATOL``, replicated within 1e-5 of
   solo; (c) the phase's seconds.
No phase was cut in depth for this: phase 6 keeps its 2 epochs.

The line before the last is a JSON object with one entry per kernel;
the last line is ``{"ok": true, "device": {...}}``. Each kernel's
``launches`` is its count over the path that drives it, read right after
that path: phase 4 for the FFN kernel, phase 3b for the attention
kernels (the model never launches them); the FFN kernel's
``bf16_launches`` is its count over phase 4b's bf16 serving run, its
``train_launches`` its count over phase 6's training run and its
``train_bf16_launches`` over phase 6b's, with ``launches_by_mix`` naming
the dtype mix of each (``mix_*``: the training mix's phase-3 fields);
``parity_train_launches``, ``packed_serve_launches``,
``packed_serve_bf16_launches`` and ``packed_train_launches`` are its counts
over phases 7, 8 (f32, bf16) and 9 (``packed_*``: the packed launch
shape's time and bound); ``accum_train_launches``,
``dispatch_train_launches`` and ``flat_train_launches`` over phase 10's
``--grad_accum 2``, ``--steps_per_dispatch 4`` and ``--flat_params``
runs; ``telemetry_train_launches`` and ``telemetry_serve_launches`` over
phase 11's instrumented training and observed serving runs;
``recovery_train_launches``, ``recovery_restore_train_launches``,
``stop_resume_train_launches``, ``preempt_resume_train_launches`` and
``ckpt_io_train_launches`` over phase 12's runs (a), (b), (c), (d) and
(e); ``metrics_train_launches``, ``deadline_serve_launches``,
``breaker_serve_launches``, ``reload_serve_launches``,
``reload_main_serve_launches``, ``reload_corrupt_serve_launches``,
``reload_bf16_serve_launches`` and ``sigterm_serve_launches`` over
phase 13's training run and its paths (a), (b), (c1), (c2), (c3), (c4)
and (d); ``rollout_serve_launches``, ``rollout_bf16_serve_launches``,
``rollout_nan_serve_launches``, ``stale_session_serve_launches``,
``replica_kill_serve_launches``, ``sigterm_resume_serve_launches`` and
``tenant_serve_launches`` over phase 14's paths (a), (c), (d), (e) and
(f); ``router_serve_launches``, ``router_bf16_serve_launches``,
``rolling_reload_serve_launches``, ``router_kill_serve_launches``,
``router_breaker_serve_launches`` and ``scale_serve_launches`` over phase
15's paths (a) f32, (a) bf16, (c), (d), (e) and (f);
``catalog_serve_launches``, ``autoscale_serve_launches`` and
``heal_serve_launches`` over phase 16's paths (a) (all six runs), (b)
and (c); ``federation_serve_launches``, ``federation_tcp_launches``,
``federation_bf16_launches`` and ``federation_kill_launches`` over phase
17's runs (a), (b), (c) and (d) (every host's replicas summed). The
``nla_reduce`` and ``nla_apply`` entries' ``sp_launches`` are their counts
under ``fused_nla_sp`` in phase 18 (a), summed over the ranks; the FFN
kernel's ``mesh_train_launches`` is its count over every rank of phase 19
(0: a mesh runs the FFN's torch path); ``native_serve_launches``,
``native_serve_numpy_launches`` and ``native_serve_f32_launches`` its
counts over phase 20's runs (b) native, (b) with the native path off and
(c), and ``native_direct_calls`` the C calls of phase 20 (a);
``mesh_serve_launches`` and ``mesh_parity_train_launches`` its counts over
both ranks of phase 21's serving runs (a) and parity runs (c), 0 (a mesh
runs the FFN's torch path); ``readers_serve_launches`` its count over phase
22 (a), the served run whose files the readers read;
``ref_scale_demo_launches``, ``ref_scale_train_launches`` and
``long_context_launches`` its counts over phase 23's runs (a), (b) and
(c) (by ``--synth_size``, the remat runs), ``ref_scale_shapes`` its time
and bound at (e)'s shapes; each attention entry's ``bf16_launches`` and
``bf16`` are its count over phase 23 (d) and its bf16 instance's time and
bound in (e); ``bench_launches`` is its count over phase 24 (a)'s two
kernel runs, ``bench_ref_scale_launches`` over (e)'s kernel run and
``pack_ab_launches`` over (g)'s ``pack_ab`` (0: both its arms run
``ffn_impl=xla``); ``abtools_launches`` is its count over phase 25 (b)'s
two kernel A/Bs (the tools of (a) run ``ffn_impl=xla``, in processes of
their own); ``load_tools_launches`` is its count over phase 26 (b)'s
warm-ups and open-loop runs, summed over the replicas. Launches
made to time a kernel or to hold it against its plain version come after
the counts are read.
The script imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA data sheet): f32 outside the
# tensor cores, TF32 and bf16 on the tensor cores (dense), and HBM3
# bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# The bf16 kernel vs its plain version on the same bf16 inputs: both
# compute in f32 and round once to bf16, so an element differs by at
# most one bf16 ulp (2^-7 of its value) where the two f32 sums round
# apart.
BF16_RTOL, BF16_ATOL = 2.0**-7, 1e-6
# bf16 serving (phase 4b) vs the same bf16 forward with every FFN through
# the kernel's plain version, relative norm over all outputs: one-ulp
# differences in ~0.07% of the FFN outputs carried through four bf16
# blocks (sound runs read 6.1e-7, worst request 1.0e-6). Phase 4b holds a
# control to the same bar and fails unless it is caught: the bf16
# ffn_impl=xla path, which rounds to bf16 between Linears.
BF16_PLAIN_REL = 1e-5
# bf16 serving vs the f32 server of the same weights, per request: the
# JAX package's own bar (tests/test_serve.py:1468, tests/test_lowprec.py:212).
BF16_F32_REL = 2e-2
# The f32 FFMA reduce kernel's max abs error against its plain version over
# every validate_kernels check on an H100, printed beside the current one.
FFMA_REDUCE_ERR = {"kv": 6.2e-6, "ksum": 5.7e-6}
# Kernel vs plain version: the kernel multiplies in 3xTF32 on the tensor
# cores (about f32's accuracy; their f32 accumulation truncates) and sums
# each 256-long dot product in another order than PyTorch's f32 matmul,
# through five chained Linears: ~1e-7 of the O(1) outputs.
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
# Served outputs vs a forward through the plain version: the JAX
# package's own model-level bar for its fused FFN against its XLA path.
MODEL_RTOL, MODEL_ATOL = 1e-4, 1e-5
# Training through the kernel vs through the plain version from the same
# weights and batches: step 1's loss at the model-level bar; later steps
# and the metrics carry the ~3e-7 forward difference through AdamW
# updates (sound runs read 1.6e-7 to 2.8e-7 relative). The bar sits well
# below what a run whose kernel reads stale weight images reads (phase
# 6 measures that control and prints it).
TRAIN_LATER_RTOL = 1e-5
TRAIN_ARGV = ["--synthetic", "ns2d", "--n_train", "16", "--n_test", "8", "--epochs", "2",
              "--batch_size", "4", "--ffn_impl", "pallas", "--device", "cuda"]
# bf16 training through the kernel vs the same run through its plain
# version (phase 6b), worst relative difference over the step losses and
# test metrics: the two forwards differ only where their f32 sums round to
# bf16 apart, one ulp in a few elements in ten thousand. A quarter of what
# bf16 itself costs the CPU run of tests/test_torch_lowprec.py (the JAX
# bf16-vs-f32 gap of its step losses, 1.4e-5 to 1.9e-5), where the port's
# bf16 run reads 0.02 to 0.06 of that gap. Two controls must fail it: f32
# training (phase 6's run) and bf16 training through the serving instance
# (bf16-cast weights, the lo product skipped).
BF16_TRAIN_REL = 5e-6
# Phase 7: parity training at full width (erf GELU, bucketing off).
PARITY_ARGV = ["--synthetic", "darcy2d", "--attention_mode", "parity", "--n_train", "16",
               "--n_test", "8", "--epochs", "2", "--batch_size", "4", "--ffn_impl", "pallas",
               "--device", "cuda"]
# Phase 8: packed serving of ragged elasticity traffic (the serve dtype is
# appended per run).
PACKED_SERVE_ARGV = ["--serve", "--serve_packed", "--synthetic", "elasticity", "--n_test", "16",
                     "--serve_max_batch", "4", "--ffn_impl", "pallas", "--device", "cuda"]
# A packed request's output against its own solo padded dispatch: only
# the summation order of the attention sums differs (tests/test_serve.py:644).
SOLO_RTOL, SOLO_ATOL = 1e-5, 1e-5
# Phase 9: packed training of ragged elasticity, and its final test metric
# against the unpacked run of the same data: the JAX bar for packed against
# unpacked eval (tests/test_trainer.py:743).
PACKED_TRAIN_ARGV = ["--synthetic", "elasticity", "--packed", "--n_train", "16", "--n_test", "8",
                     "--epochs", "2", "--batch_size", "4", "--ffn_impl", "pallas",
                     "--device", "cuda"]
PACKED_EVAL_RTOL = 0.05
# Phase 10: the rest of the training loop, one epoch each (4 batches, 2
# eval batches); the options are appended per run.
LOOP_ARGV = ["--synthetic", "ns2d", "--n_train", "16", "--n_test", "8", "--epochs", "1",
             "--batch_size", "4", "--ffn_impl", "pallas", "--device", "cuda"]
# The stacked layout runs the standard layout's kernels in the same order.
SCAN_RTOL = 1e-5
# Phase 11: phase 6's training with the observability plane on (the
# metrics, trace and profile paths are appended per run, under TRAIN_OUT).
OBS_FLAGS = ["--telemetry", "--log_every", "1"]
# The keys of every telemetry step record besides each block's gate stats.
TELEMETRY_KEYS = ("step", "epoch", "loss", "lr", "grad_norm", "update_norm", "param_norm",
                  "padding_waste")
# A gate-load vector is a mean of softmax rows: it sums to 1 but for f32
# rounding.
GATE_SUM_ATOL = 1e-5
# Phase 11's serving run: phase 4's traffic, with a sink and a tracer.
OBS_SERVE_ARGV = ["--serve", "--ffn_impl", "pallas", "--synthetic", "ns2d", "--n_test", "16",
                  "--serve_max_batch", "4", "--device", "cuda"]
# Phase 13's serving runs: phase 4's traffic (the checkpoint, metrics path
# and the phase's flags are appended per run).
SERVE13_ARGV = ["--serve", "--ffn_impl", "pallas", "--synthetic", "ns2d", "--n_test", "16",
                "--serve_max_batch", "4", "--device", "cuda"]
# Phase 14's rollout serving: phase 4's traffic through main (the rollout,
# metrics path and the phase's flags are appended per run), 8 steps a
# session.
ROLLOUT_ARGV = SERVE13_ARGV
ROLLOUT_K = 8
# A served rollout against offline_rollout on the same engine, per step:
# the JAX package's bar (gnot_tpu/serve/rollout.py::offline_rollout).
ROLLOUT_PARITY = 1e-5
# Where phase 6b keeps its checkpoints and phase 6c writes what it exports:
# under the checkout's gitignored build/, emptied first.
TRAIN_OUT = ROOT / "build" / "chip_smoke"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 20, warmup: int = 3, attempts: int = 3) -> float:
    """Mean device time of one ``fn()``: the summed duration of every
    kernel it runs on the card over ``iters`` calls, over ``iters``
    (``profiling.kernel_times``, CUPTI). Unlike ``cuda_ms`` it leaves out
    the host's time between launches, which bounds short kernels called
    from Python. After ``attempts`` profiles without device events the
    time is ``cuda_ms``'s (CUDA events over back-to-back calls, host
    included), which the log says."""
    from gnot_tpu_torch.profiling import kernel_times

    times = kernel_times(fn, iters, warmup, attempts, log=log)
    if times is not None:
        return sum(times.values())
    log(f"[profiler] {attempts} profiles recorded no device time: CUDA events over "
        "back-to-back calls instead (host enqueue included)")
    return cuda_ms(torch, fn, iters, warmup)


def ffn_inputs(torch, np, b: int, l: int, width: int, n_expert: int, n_linears: int, seed: int):
    """x, scores, kernels, biases on the card, from a numpy seed; the
    weights follow the model's init (U(+-1/sqrt(fan_in)))."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, width), dtype=np.float32)
    logits = rng.standard_normal((b, l, n_expert), dtype=np.float32)
    scores = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    bound = 1.0 / np.sqrt(width)
    kernels = [
        rng.uniform(-bound, bound, (n_expert, width, width)).astype(np.float32)
        for _ in range(n_linears)
    ]
    biases = [
        rng.uniform(-bound, bound, (n_expert, width)).astype(np.float32)
        for _ in range(n_linears)
    ]
    dev = torch.device("cuda")
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    return to(x), to(scores), [to(k) for k in kernels], [to(bb) for bb in biases]


def product_passes(a_f32: bool, w_f32: bool) -> tuple[int, int]:
    """Tensor-core products per multiply-add that keep f32 accuracy, as
    (TF32 products, bf16 products), for an activation and a weight that
    are f32 or exact in bf16. An f32 operand splits into a TF32 hi and lo
    (two pieces) or into three bf16 pieces (8 + 8 + 8 significand bits);
    a bf16 operand is one piece in either. Cross terms below f32's
    precision are dropped (TF32 lo x lo; bf16 pieces whose ranks sum past
    2)."""
    if a_f32 and w_f32:
        return 3, 6
    if a_f32 or w_f32:
        return 2, 3
    return 1, 1


def ffn_bound_ms(x, scores, kernels, biases, tensor_cores: bool = True) -> tuple[float, str]:
    """Least time for the FFN's work on the card: the larger of its
    compulsory bytes (inputs read once, output written once, each at its
    own dtype's size) over the memory rate and its operations over their
    peak. With ``tensor_cores`` each Linear's products take the faster of
    the TF32 and the bf16 split (``product_passes``) for its operands'
    types: Linear 0 reads x, the later ones the f32 hidden activations;
    bias and gate run at the f32 rate beside them. For f32 x and weights
    that is 3xTF32 on every Linear (the kernel's form); for the bf16 mix,
    one bf16 product on Linear 0 and three on the others. Without
    ``tensor_cores`` everything counts once at the f32 CUDA-core rate
    (the bound of the earlier f32 kernel)."""
    from gnot_tpu_torch.obs.costs import ffn_flops

    rows = x.shape[0] * x.shape[1]
    n_expert = scores.shape[-1]
    d_out = kernels[-1].shape[-1]
    # The products and the gate's weighted sum, as the program catalog counts them.
    flops, gate = ffn_flops(rows, n_expert, [(k.shape[1], k.shape[2]) for k in kernels])
    elementwise = sum(rows * n_expert * k.shape[2] for k in kernels) + gate
    nbytes = (
        x.element_size() * (x.numel() + rows * d_out) + scores.element_size() * scores.numel()
        + sum(t.element_size() * t.numel() for t in (*kernels, *biases))
    )
    if tensor_cores:
        t_products = 0.0
        for i, (f, k) in enumerate(zip(flops, kernels)):
            a_f32 = i > 0 or x.element_size() == 4
            tf32, bf16 = product_passes(a_f32, k.element_size() == 4)
            t_products += f * min(tf32 / PEAK_TF32_FLOPS, bf16 / PEAK_BF16_FLOPS)
        t_ops = max(t_products, elementwise / PEAK_F32_FLOPS)
    else:
        t_ops = (sum(flops) + elementwise) / PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def sass_count(build, name: str, opcode: str) -> int:
    """Instructions of one SASS opcode (``HGMMA``: ``wgmma``; ``HMMA``:
    ``mma.sync``) in a built library, read with the toolkit's
    ``cuobjdump`` (or the copy Triton ships)."""
    import importlib.util

    candidates = [Path(build.nvcc()).parent / "cuobjdump"]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        candidates.append(Path(spec.origin).parent / "backends" / "nvidia" / "bin" / "cuobjdump")
    tool = next((c for c in candidates if c.is_file()), None)
    if tool is None:
        raise RuntimeError(f"no cuobjdump among {[str(c) for c in candidates]}")
    out = subprocess.run([str(tool), "-sass", str(build.library_path(name))],
                         capture_output=True, text=True, timeout=300, check=True)
    pattern = re.compile(rf"\b{opcode}\b")
    return sum(bool(pattern.search(line)) for line in out.stdout.splitlines())


def xla_ffn_path(torch, layers, kernels, biases, gelu: str):
    """The model's ``ffn_impl="xla"`` FFN module holding these weights, in
    their dtype: an expert MLP of batched cuBLAS GEMMs (f32, or bf16 for
    bf16 weights), then the gate einsum."""
    n_expert, d_in, hidden = kernels[0].shape
    dtype = kernels[0].dtype
    ffn = layers.GatedExpertFfn(
        n_expert, len(kernels) - 1, hidden, kernels[-1].shape[-1], in_dim=d_in, ffn_impl="xla",
        gelu=gelu, dtype=None if dtype == torch.float32 else dtype,
    ).to(device=kernels[0].device, dtype=dtype)
    with torch.no_grad():
        for layer, k, b in zip(ffn.experts.layers(), kernels, biases):
            layer.kernel.copy_(k)
            layer.bias.copy_(b)
    return ffn.eval()


def to_bf16(args):
    """The bf16 serving mix of FFN inputs: x, weights and biases rounded
    to bf16, the gate scores left f32."""
    x, scores, kernels, biases = args
    return (x.bfloat16(), scores, [k.bfloat16() for k in kernels],
            [b.bfloat16() for b in biases])


def bf16_ffn_phase(torch, np, layers, card, f32_kernel_ms, kernel, reference) -> dict:
    """Phase 3, bf16: the FFN kernel on the bf16 mix at the serving launch
    shape against its plain version on the same inputs, then its device
    time beside the f32 kernel's (measured just before in this run), the
    plain version's and the ``ffn_impl="xla"`` torch path in bf16. Returns
    the bf16 fields of the kernel's entry."""
    worst, max_abs = 0.0, 0.0
    for (b, l), gelu in [((4, 1024), "tanh"), ((4, 1024), "erf"), ((3, 1000), "tanh")]:
        args = to_bf16(ffn_inputs(torch, np, b, l, 256, 3, 5, seed=b * l + 1))
        got = kernel(*args, gelu_kind=gelu)
        want = reference(*args, gelu_kind=gelu)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        differ = (got != want).float().mean().item()
        ulps = (err / want.float().abs().clamp_min(BF16_ATOL / BF16_RTOL)).max().item() / BF16_RTOL
        log(f"[ffn-bf16] x [{b},{l},256] bf16, weights and biases bf16, scores f32, E=3 5 Linears "
            f"gelu={gelu}: out {got.dtype}; max_abs_err {err.max().item():.3e}, worst {ulps:.3f} "
            f"of the bar (one bf16 ulp: rtol 2^-7 atol {BF16_ATOL}); {differ:.4%} of elements not "
            f"bitwise equal to the plain version")
        if got.dtype != torch.bfloat16:
            raise RuntimeError(f"the bf16 kernel wrote {got.dtype}")
        torch.testing.assert_close(got.float(), want.float(), rtol=BF16_RTOL, atol=BF16_ATOL)
        worst, max_abs = max(worst, ulps), max(max_abs, err.max().item())

    args = to_bf16(ffn_inputs(torch, np, 4, 1024, 256, 3, 5, seed=7))
    kernel_call = lambda: kernel(*args, gelu_kind="tanh")  # noqa: E731
    plain_call = lambda: reference(*args, gelu_kind="tanh")  # noqa: E731
    xla_ffn = xla_ffn_path(torch, layers, args[2], args[3], "tanh")
    with torch.inference_mode():
        torch_call = lambda: xla_ffn(args[0], args[1])  # noqa: E731
        xla_err = (torch_call().float() - plain_call().float()).abs().max().item()
        bf16_ms = device_ms(torch, kernel_call)
        plain_ms = device_ms(torch, plain_call)
        xla_ms = device_ms(torch, torch_call)
    bound_ms, bound_by = ffn_bound_ms(*args)
    # The kernel's own form: 3xTF32 less the product with the bf16
    # weights' all-zero lo image, two TF32 products on every Linear.
    rows, n_expert = args[0].shape[0] * args[0].shape[1], args[1].shape[-1]
    form_ms = sum(2 * rows * n_expert * 2 * k.shape[1] * k.shape[2]
                  for k in args[2]) / PEAK_TF32_FLOPS * 1e3
    log(f"[ffn-bf16] time at [4,1024,256] E=3 5 Linears tanh, bf16 mix, weights warm in L2: "
        f"device time kernel {bf16_ms:.4f} ms (the f32 kernel {f32_kernel_ms:.4f} ms in this run), "
        f"plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}: bf16 tensor cores, one "
        f"product on Linear 0's bf16 x and weights, three on each later Linear's f32 "
        f"activations split into three bf16 pieces), {bound_ms / bf16_ms:.1%} of bound; the "
        f"kernel's own form (2 TF32 products on every Linear) {form_ms:.4f} ms; the "
        f"ffn_impl=xla torch path in bf16 (batched cuBLAS bf16 GEMMs, bf16 between Linears) "
        f"{xla_ms:.4f} ms, its max_abs_err vs the plain version {xla_err:.3e} on {card}")
    return dict(bf16_ms=bf16_ms, bf16_plain_ms=plain_ms, bf16_max_abs_err=max_abs,
                bf16_bound_ms=bound_ms, bf16_xla_ms=xla_ms)


def training_mix_ffn_phase(torch, np, card, f32_kernel_ms, kernel, reference) -> dict:
    """Phase 3, the bf16 training mix: the FFN kernel on bf16 x with f32
    weights and biases (and f32 scores) at the training launch shape and a
    ragged one, both GELUs. It must be bitwise the f32 instance run on the
    widened x with its output rounded to bf16 (the same products, the lo
    weight image included, one rounding at the store), and within one bf16
    ulp of its plain version. Then its device time beside the f32
    kernel's, the plain version's and its bound. Returns the mix's fields
    of the kernel's entry."""
    max_abs = 0.0
    for (b, l), gelu in [((4, 1024), "tanh"), ((4, 1024), "erf"), ((3, 1000), "tanh"),
                         ((3, 1000), "erf")]:
        x, scores, kernels, biases = ffn_inputs(torch, np, b, l, 256, 3, 5, seed=b * l + 2)
        x = x.bfloat16()
        got = kernel(x, scores, kernels, biases, gelu_kind=gelu)
        f32 = kernel(x.float(), scores, kernels, biases, gelu_kind=gelu).bfloat16()
        want = reference(x, scores, kernels, biases, gelu_kind=gelu)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        ulps = (err / want.float().abs().clamp_min(BF16_ATOL / BF16_RTOL)).max().item() / BF16_RTOL
        not_f32 = int((got != f32).sum().item())
        log(f"[ffn-mix] x [{b},{l},256] bf16, weights and biases f32, scores f32, E=3 5 Linears "
            f"gelu={gelu}: out {got.dtype}; {not_f32} of {got.numel()} elements differ from the "
            f"f32 instance on the widened x rounded once to bf16; vs the plain version max_abs_err "
            f"{err.max().item():.3e}, worst {ulps:.3f} of the bar (one bf16 ulp), "
            f"{(got != want).float().mean().item():.4%} of elements not bitwise equal")
        if got.dtype != torch.bfloat16 or not_f32:
            raise RuntimeError(f"the training-mix kernel is not the f32 kernel rounded once: "
                               f"{got.dtype}, {not_f32} elements differ")
        torch.testing.assert_close(got.float(), want.float(), rtol=BF16_RTOL, atol=BF16_ATOL)
        max_abs = max(max_abs, err.max().item())

    x, scores, kernels, biases = ffn_inputs(torch, np, 4, 1024, 256, 3, 5, seed=7)
    args = (x.bfloat16(), scores, kernels, biases)
    with torch.inference_mode():
        mix_ms = device_ms(torch, lambda: kernel(*args, gelu_kind="tanh"))
        plain_ms = device_ms(torch, lambda: reference(*args, gelu_kind="tanh"))
    bound_ms, bound_by = ffn_bound_ms(*args)
    log(f"[ffn-mix] time at [4,1024,256] E=3 5 Linears tanh, bf16 x, f32 weights warm in L2: "
        f"device time kernel {mix_ms:.4f} ms (the f32 kernel {f32_kernel_ms:.4f} ms in this run), "
        f"plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}: Linear 0's f32 weights in "
        f"three bf16 pieces against its bf16 x on the bf16 tensor cores, 3xTF32 on the later "
        f"Linears), {bound_ms / mix_ms:.1%} of bound on {card}")
    return dict(mix_ms=mix_ms, mix_plain_ms=plain_ms, mix_max_abs_err=max_abs,
                mix_bound_ms=bound_ms)


def profile_dispatch(torch, engine, group) -> tuple[float, float, list]:
    """One warm 4-row dispatch of ``group`` under ``torch.profiler``:
    (device busy ms, wall ms, kernel rows longest first)."""
    from torch.profiler import ProfilerActivity, profile

    key = engine.bucket_key(group[0])

    def dispatch():
        return engine.infer(group, pad_nodes=key[0], pad_funcs=key[1], rows=4)

    dispatch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dispatch()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = kernel_rows(prof)
    return sum(r[0] for r in rows), wall_ms, rows


def bf16_serving_phase(torch, np, port_main, layers, f32_run, f32_peak_mib, card) -> int:
    """Phase 4b: ``--serve_dtype bfloat16`` at full width through the
    port's serve entry point, with the counts set to 0 just before and
    read just after. Returns the FFN kernel's launches over the run."""
    from gnot_tpu_torch.ops.fused_ffn import (
        fused_gated_ffn,
        fused_gated_ffn_kernel,
        fused_gated_ffn_reference,
    )
    from gnot_tpu_torch.serve.engine import InferenceEngine

    argv = ["--serve", "--serve_dtype", "bfloat16", "--ffn_impl", "pallas", "--synthetic",
            "ns2d", "--n_test", "16", "--serve_max_batch", "4", "--device", "cuda"]
    args = port_main.build_parser().parse_args(argv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_gated_ffn_kernel.launches = 0
    fused_gated_ffn_kernel.launches_by_dtype = {}
    run = port_main.run_serve(args)
    launches = fused_gated_ffn_kernel.launches
    by_dtype = dict(fused_gated_ffn_kernel.launches_by_dtype)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    summary = run.summary
    log(f"[serve-bf16] python -m gnot_tpu_torch.main {' '.join(argv)}")
    log(f"[serve-bf16] summary {json.dumps(summary)}")
    n_ok = sum(r.ok for r in run.results)
    if n_ok != len(run.results) or len(run.results) != 16 or summary["dtype"] != "bfloat16":
        raise RuntimeError(f"{n_ok}/{len(run.results)} bf16 requests ok, dtype {summary['dtype']}: "
                           f"{[(r.reason, r.detail) for r in run.results if not r.ok]}")
    cfg = run.model.config
    dispatches = summary["dispatches"] + summary["warmed_buckets"]
    expected = 2 * cfg.n_attn_layers * dispatches
    log(f"[serve-bf16] {n_ok}/16 ok; fused_gated_ffn launches {launches} = 2 x "
        f"{cfg.n_attn_layers} blocks x {dispatches} dispatches ({summary['dispatches']} served + "
        f"{summary['warmed_buckets']} warm-up), by dtype {json.dumps(by_dtype)}")
    if launches != expected or launches == 0 or by_dtype != {"bf16": launches}:
        raise RuntimeError(f"expected {expected} bf16 FFN kernel launches, counted {launches} "
                           f"{by_dtype}")
    for r in run.results:
        if r.output.dtype != np.float32 or not np.all(np.isfinite(r.output)):
            raise RuntimeError(f"bad bf16 served output {r.output.dtype}")

    # The same bf16 forward with every FFN through the kernel's plain version.
    layers.fused_gated_ffn = fused_gated_ffn_reference
    try:
        plain = InferenceEngine(run.model, batch_size=4, dtype="bfloat16").predict(run.samples)
    finally:
        layers.fused_gated_ffn = fused_gated_ffn
    # The control: the same weights served in bf16 through ffn_impl=xla,
    # which rounds to bf16 between Linears, as the kernel must not.
    with torch.device("meta"):
        xla_model = type(run.model)(dataclasses.replace(cfg, ffn_impl="xla"))
    xla_model.load_state_dict(run.model.state_dict(), strict=True, assign=True)
    control = InferenceEngine(xla_model.eval(), batch_size=4, dtype="bfloat16").predict(run.samples)
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))  # noqa: E731
    plain_all = np.concatenate(plain)
    plain_rel = rel(np.concatenate([r.output for r in run.results]), plain_all)
    control_rel = rel(np.concatenate(control), plain_all)
    plain_worst = max(rel(r.output, w) for r, w in zip(run.results, plain))
    f32_rels = [rel(r.output, w.output) for r, w in zip(run.results, f32_run.results)]
    log(f"[serve-bf16] outputs vs the same bf16 forward through the kernel's plain version on "
        f"the card: relative norm {plain_rel:.3e} over all outputs, worst request {plain_worst:.3e} "
        f"(bar {BF16_PLAIN_REL} over all outputs); the control (ffn_impl=xla in bf16, rounding "
        f"between Linears) reads {control_rel:.3e}, {control_rel / BF16_PLAIN_REL:.1f}x the bar")
    if control_rel <= BF16_PLAIN_REL:
        raise RuntimeError(f"the bar {BF16_PLAIN_REL} does not catch the control ({control_rel})")
    log(f"[serve-bf16] outputs vs phase 4's f32 server of the same weights: relative norm per "
        f"request max {max(f32_rels):.3e} median {statistics.median(f32_rels):.3e} (bar "
        f"{BF16_F32_REL} per request)")
    if plain_rel > BF16_PLAIN_REL or max(f32_rels) >= BF16_F32_REL:
        raise RuntimeError(f"bf16 serving off its bars: {plain_rel} vs plain, "
                           f"{max(f32_rels)} vs f32")

    f32_summary = f32_run.summary
    log(f"[serve-bf16] host clock, bf16 vs phase 4's f32 run: dispatch p50 "
        f"{summary['dispatch_ms_p50']:.3f} vs {f32_summary['dispatch_ms_p50']:.3f} ms, max "
        f"{summary['dispatch_ms_max']:.3f} vs {f32_summary['dispatch_ms_max']:.3f} ms; request "
        f"latency p50 {summary['latency_p50_ms']:.3f} vs {f32_summary['latency_p50_ms']:.3f} ms, "
        f"p99 {summary['latency_p99_ms']:.3f} vs {f32_summary['latency_p99_ms']:.3f} ms; peak "
        f"device memory {peak_mib:.1f} MiB (phase 4: {f32_peak_mib:.1f} MiB)")
    group = run.samples[:4]
    engines = {"bf16": InferenceEngine(run.model, batch_size=4, dtype="bfloat16"),
               "f32": InferenceEngine(f32_run.model, batch_size=4)}
    top = {}
    for label in ("f32", "bf16", "bf16", "f32"):
        busy, wall, top[label] = profile_dispatch(torch, engines[label], group)
        ffn_ms = sum(r[0] for r in top[label] if "fused_gated_ffn" in r[2])
        ffn_n = sum(r[1] for r in top[label] if "fused_gated_ffn" in r[2])
        log(f"[serve-bf16] one {label} dispatch (ffn_impl=pallas): device busy {busy:.3f} ms of "
            f"{wall:.3f} ms wall ({busy / wall:.1%} busy) in {sum(r[1] for r in top[label])} "
            f"kernels; fused_gated_ffn {ffn_ms:.3f} ms in {ffn_n} launches")
    for label, rows in top.items():
        for ms, count, name in rows[:8]:
            log(f"[serve-bf16]   {label:4s} {ms:8.3f} ms  x{count:<4d} {name[:90]}")
    return launches


def attention_bounds(name: str, c: dict, n_head: int,
                     tensor_cores: bool = False) -> tuple[float, str]:
    """Least time for one attention stage on the case's inputs: the larger
    of its bytes (each input read once, each output written once, at its
    dtype's size: the Grams f32, q, k, v, the mask, out and qs f32 or bf16)
    over the memory rate and the operations this data needs over their peak.
    Operations count only rows that reach an output: for a reduce, key
    rows with mask != 0 in a chunk with a slot (2 E^2 for the Gram, ~6 E
    for softmax, mask and k_sum); for an apply, ~6 E per query row for the
    softmax and, per input function, 2 E D + 3 E per row of a chunk with a
    slot (the head-diagonal product, the denominator and the division).
    An apply reads only the head-diagonal blocks of the Grams it uses.
    Everything counts at the f32 CUDA-core rate, except that with
    ``tensor_cores`` a reduce's Gram takes the faster of the TF32 and the
    bf16 split of its operands, the f32 softmax of k against an f32 or bf16
    v (``product_passes``, as ``ffn_bound_ms``: 3xTF32 for f32 v, the
    kernel's form), with the rest at the f32 rate beside it."""
    q, k, mask = c["q"], c["k"], c["mask"]
    f, bk, lk, e = k.shape
    b, l, _ = q.shape
    d = e // n_head
    seg_bytes = 0
    if "q_seg" in c:
        n_seg = c["n_seg"]
        kv_seg, q_seg = c["kv_seg"], c["q_seg"]
        key_live = ((kv_seg >= 0) & (kv_seg < n_seg)).repeat_interleave(lk // kv_seg.shape[1], 1)
        q_live = ((q_seg >= 0) & (q_seg < n_seg)).repeat_interleave(l // q_seg.shape[1], 1)
        slots_used = int(q_seg[(q_seg >= 0) & (q_seg < n_seg)].unique().numel())
        seg_bytes = 4 * (kv_seg.numel() if name.startswith("nla_reduce") else q_seg.numel())
    else:
        n_seg = bk
        key_live = q.new_ones(bk, lk, dtype=bool)
        q_live = q.new_ones(b, l, dtype=bool)
        slots_used = b
    if name.startswith("nla_reduce"):
        rows = int(((mask != 0) & key_live[None]).sum())
        gram, rest = rows * 2 * e * e, rows * 6 * e
        nbytes = (2 * k.element_size() * k.numel() + mask.element_size() * mask.numel()
                  + 4 * f * n_seg * (e * e + e) + seg_bytes)
    else:
        gram, rest = 0, b * l * 6 * e + f * int(q_live.sum()) * (2 * e * d + 3 * e)
        nbytes = (q.element_size() * (2 * q.numel() + f * b * l * e)
                  + 4 * f * slots_used * (e * d + e) + seg_bytes)
    if tensor_cores and gram:
        # The Gram's A is the f32 softmax of k; its B is v, f32 or bf16.
        tf32, bf16 = product_passes(True, c["v"].element_size() == 4)
        t_ops = max(gram * min(tf32 / PEAK_TF32_FLOPS, bf16 / PEAK_BF16_FLOPS),
                    rest / PEAK_F32_FLOPS)
    else:
        t_ops = (gram + rest) / PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def tf32_control(torch, name: str, plain, got, case_name: str) -> float:
    """The plain reduce with cuBLAS TF32 on (one TF32 product, the form
    3xTF32 replaces) against the f32 plain version, as the worst multiple
    of ``OUT_TOL``'s allowance; raises unless it exceeds the bar, which
    the kernel's output ``got`` is printed against too. Restores the flag."""
    from gnot_tpu_torch import validate_kernels as vk

    rtol, atol = vk.OUT_TOL
    want = plain()
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = plain()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved

    def worst(outs) -> float:
        return max(((o - w).abs() / (atol + rtol * w.abs())).max().item()
                   for o, w in zip(outs, want))

    control, kernel = worst(tf32), worst(got)
    log(f"[attn] {name} {case_name}: worst |x - plain| / (atol + rtol |plain|) at OUT_TOL: "
        f"kernel {kernel:.3f}, plain with cuBLAS TF32 (one TF32 product, the control) {control:.3f}")
    if control <= 1.0:
        raise RuntimeError(f"{name} {case_name}: the one-TF32-product control holds OUT_TOL, so "
                           "the bar cannot tell 3xTF32 from 1xTF32")
    return control


def attention_phase(torch, device, card: str) -> dict[str, dict]:
    """Phase 3b: the validation entry point with the counts read around
    it, then the attention kernels timed at full width. Returns each
    attention kernel's entry of the kernels line."""
    from gnot_tpu_torch import validate_kernels as vk
    from gnot_tpu_torch.ops import fused_attention as fa
    from gnot_tpu_torch.ops.fused_ffn import fused_gated_ffn_kernel

    wrappers = {
        "nla_reduce": fa.nla_reduce_kernel,
        "nla_apply": fa.nla_apply_kernel,
        "nla_reduce_seg": fa.nla_reduce_seg_kernel,
        "nla_apply_seg": fa.nla_apply_seg_kernel,
    }
    for w in wrappers.values():
        w.launches = 0
    fused_gated_ffn_kernel.launches = 0
    checks = vk.run(device)
    launches = {n: w.launches for n, w in wrappers.items()}
    log(f"[attn] python -m gnot_tpu_torch.validate_kernels: {len(checks)} checks; launches "
        f"{json.dumps(launches)}, fused_gated_ffn {fused_gated_ffn_kernel.launches}")
    failed = [f"{c.group} {c.name}" for c in checks if not c.ok]
    if failed:
        raise RuntimeError(f"kernel checks failed: {failed}")
    idle = [n for n, count in launches.items() if count == 0]
    if idle or fused_gated_ffn_kernel.launches == 0:
        raise RuntimeError(f"kernels never launched by validate_kernels: {idle}")
    for name in ("nla_reduce", "nla_reduce_seg"):
        errs = {out: max(c.max_abs_err for c in checks
                         if c.kernel == name and c.name.endswith(f" {out}"))
                for out in ("kv", "ksum")}
        log(f"[attn] {name} (3xTF32 mma.sync) max_abs_err over validate_kernels: kv "
            f"{errs['kv']:.3e}, ksum {errs['ksum']:.3e} (the f32 FFMA kernel before it: kv "
            f"{FFMA_REDUCE_ERR['kv']:.1e}, ksum {FFMA_REDUCE_ERR['ksum']:.1e}; tolerance rtol "
            f"{vk.OUT_TOL[0]} atol {vk.OUT_TOL[1]})")

    n_head = vk.N_HEAD
    cases = vk.full_width_cases(device)

    def stage_calls(name: str, c: dict):
        """(kernel call, plain call) of one stage on case ``c``; an apply
        stage takes the plain version's Grams."""
        kv_args = (c["k"], c["v"], c["mask"])
        if name == "nla_reduce":
            return (lambda: fa.nla_reduce_kernel(*kv_args, n_head),
                    lambda: fa.reduce_reference(*kv_args, n_head))
        if name == "nla_reduce_seg":
            seg = (c["kv_seg"], c["n_seg"], n_head)
            return (lambda: fa.nla_reduce_seg_kernel(*kv_args, *seg),
                    lambda: fa.reduce_seg_reference(*kv_args, *seg))
        if name == "nla_apply":
            grams = fa.reduce_reference(*kv_args, n_head)
            return (lambda: fa.nla_apply_kernel(c["q"], *grams, n_head),
                    lambda: fa.apply_reference(c["q"], *grams, n_head))
        grams = fa.reduce_seg_reference(*kv_args, c["kv_seg"], c["n_seg"], n_head)
        return (lambda: fa.nla_apply_seg_kernel(c["q"], *grams, c["q_seg"], n_head),
                lambda: fa.apply_seg_reference(c["q"], *grams, c["q_seg"], n_head))

    timed = {}
    for name, case_names in (("nla_reduce", ("self", "cross")),
                             ("nla_apply", ("self", "cross")),
                             ("nla_reduce_seg", ("self_packed", "cross_packed")),
                             ("nla_apply_seg", ("self_packed", "cross_packed"))):
        for case_name in case_names:
            c = cases[case_name]
            kernel, plain = stage_calls(name, c)
            err = max((got - want).abs().max().item() for got, want in zip(kernel(), plain()))
            kernel_ms = device_ms(torch, kernel)
            plain_ms = device_ms(torch, plain)
            bound_ms, bound_by = attention_bounds(name, c, n_head, tensor_cores=True)
            times = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
            bounds = f"bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / kernel_ms:.1%} of bound"
            reduce = name.startswith("nla_reduce")
            if reduce:
                f32_bound_ms, f32_bound_by = attention_bounds(name, c, n_head)
                times.update(f32_bound_ms=f32_bound_ms, f32_bound_by=f32_bound_by)
                bounds = (f"3xTF32 tensor-core {bounds}; f32 CUDA-core bound {f32_bound_ms:.4f} "
                          f"ms ({f32_bound_by}), {f32_bound_ms / kernel_ms:.1%} of it")
            log(f"[attn] {name} {case_name} q {list(c['q'].shape)} k {list(c['k'].shape)}: device time "
                f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms; {bounds}; back-to-back calls "
                f"(host included) kernel {cuda_ms(torch, kernel):.4f} ms, plain "
                f"{cuda_ms(torch, plain):.4f} ms; max_abs_err {err:.3e} on {card}")
            if reduce:
                times["tf32_control"] = tf32_control(torch, name, plain, kernel(), case_name)
            # The entry's top level is the self case's; "cases" holds both.
            entry = timed.setdefault(name, {"cases": {}})
            entry["cases"][case_name] = times
            if case_name in ("self", "self_packed"):
                entry.update(times)

    # The composed kernels beside the torch einsum paths the model runs
    # (several PyTorch calls each, not one library call).
    for case_name in ("self", "cross", "self_packed", "cross_packed"):
        c = cases[case_name]
        dense = (c["q"], c["k"], c["v"], c["mask"])
        if "q_seg" in c:
            seg = (c["q_seg"], c["kv_seg"], c["n_seg"], n_head)
            fused = lambda: fa.fused_nla_packed(*dense, *seg)  # noqa: E731
            torch_path = lambda: vk.packed_einsum_path(*dense, *seg)  # noqa: E731
            what = "fused_nla_packed vs packed_normalized_linear_attention"
        else:
            fused = lambda: fa.fused_nla(*dense, n_head)  # noqa: E731
            torch_path = lambda: vk.einsum_path(*dense, n_head)  # noqa: E731
            what = "fused_nla vs split-head normalized_linear_attention"
        with torch.no_grad():
            fused_dev, torch_dev = device_ms(torch, fused), device_ms(torch, torch_path)
            fused_ms, torch_ms = cuda_ms(torch, fused), cuda_ms(torch, torch_path)
        log(f"[attn] {case_name}: {what}: device time kernels {fused_dev:.4f} ms, torch "
            f"einsum path {torch_dev:.4f} ms ({torch_dev / fused_dev:.2f}x); back-to-back "
            f"calls (host included) {fused_ms:.4f} ms vs {torch_ms:.4f} ms "
            f"({torch_ms / fused_ms:.2f}x) on {card}")
    return {n: dict(launches=launches[n], max_abs_err=max(
        c.max_abs_err for c in checks if c.kernel == n), **timed[n]) for n in wrappers}


def where_the_time_goes(torch, kernel_model, plain_model, group, engine_cls) -> None:
    """One 4-row serving dispatch at full width: host-clock time with the
    fused FFN kernel and with the plain torch FFN path, in turns
    (plain, kernel, kernel, plain; median of 10 each), then a
    ``torch.profiler`` trace of one kernel dispatch: device time by
    kernel and the device's busy share of the dispatch's wall time."""
    engines = {"xla": engine_cls(plain_model, batch_size=4),
               "pallas": engine_cls(kernel_model, batch_size=4)}
    key = engines["pallas"].bucket_key(group[0])

    def dispatch(label):
        return engines[label].infer(group, pad_nodes=key[0], pad_funcs=key[1], rows=4)

    medians: dict[str, list[float]] = {"xla": [], "pallas": []}
    for label in ("xla", "pallas", "pallas", "xla"):
        dispatch(label)
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            dispatch(label)  # ends in a device-to-host copy: synchronised
            times.append((time.perf_counter() - t0) * 1e3)
        medians[label].append(sorted(times)[len(times) // 2])
    log(f"[time] dispatch [4 rows x {key[0]} points] host clock, median of 10, "
        f"turns xla/pallas/pallas/xla: ffn_impl=xla {medians['xla']} ms, "
        f"ffn_impl=pallas {medians['pallas']} ms")

    busy_ms, wall_ms, rows = profile_dispatch(torch, engines["pallas"], group)
    log(f"[time] one pallas dispatch: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall "
        f"({busy_ms / wall_ms:.1%} busy, {1 - busy_ms / wall_ms:.1%} idle)")
    for ms, count, name in rows[:10]:
        log(f"[time]   {ms:8.3f} ms  x{count:<4d} {name[:90]}")


def kernel_rows(prof) -> list[tuple[float, int, str]]:
    """``(device ms, count, name)`` of every kernel in a profile, longest
    first. Ranges the profiler draws on the device's timeline around
    annotated host code (``Optimizer.step#AdamW.step``) are left out:
    they span kernels already counted."""
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if getattr(evt, "is_user_annotation", False):
            continue
        if str(getattr(evt, "device_type", "")).endswith("CUDA") and dev_us > 0:
            rows.append((dev_us / 1e3, evt.count, evt.key))
    return sorted(rows, reverse=True)


def train_quietly(port_main, args):
    """``run_train`` with its console lines captured: (trainer, lines)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        trainer = port_main.run_train(args)
    return trainer, out.getvalue().splitlines()


def check_reference_lines(lines: list[str], epochs: int) -> None:
    """The reference's console lines, each number finite."""
    for e in range(epochs):
        for head in (f"Epoch {e}, Loss: ", f"Epoch {e}, Test Metric: "):
            found = [line for line in lines if line.startswith(head)]
            if len(found) != 1 or not math.isfinite(float(found[0][len(head):])):
                raise RuntimeError(f"expected one finite {head!r} line, got {found}")
    best = [line for line in lines if line.startswith("Best Test Metric: ")]
    if len(best) != 1 or not math.isfinite(float(best[0].split(": ")[1])):
        raise RuntimeError(f"expected one finite best-metric line, got {best}")


def fresh_trainer(trainer_cls, trainer, ffn_impl: str):
    """A new trainer with the run's config, data and seed and the given
    ``ffn_impl``, its optimizer made."""
    mc = dataclasses.replace(trainer.model_cfg, ffn_impl=ffn_impl)
    fresh = trainer_cls(trainer.config, mc, trainer.train_loader.samples, [],
                        device=trainer.device)
    fresh.initialize()
    return fresh


def step_times(torch, trainer_cls, trainer, ffn_impl: str) -> list[float]:
    """Host-clock ms of each AdamW step of a fresh trainer with the given
    ``ffn_impl``, each step waited for: two epochs of the train loader."""
    fresh = fresh_trainer(trainer_cls, trainer, ffn_impl)
    times = []
    for epoch in range(2):
        fresh.train_loader.set_epoch(epoch)
        for batch in fresh.train_loader:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fresh.train_step(batch, fresh.lr_fn(fresh.host_step, epoch))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def step_phases(torch, batch_loss, trainer, batch, reps: int = 5) -> dict[str, tuple[float, float]]:
    """``{phase: (host ms, CUDA-event ms)}`` of one AdamW step cut into
    forward, backward and optimizer, medians of ``reps``. The card is
    waited for after each phase, so a phase's host time is its enqueue
    plus whatever the card still had to run of it."""
    host: dict[str, list[float]] = {"forward": [], "backward": [], "optimizer": []}
    dev: dict[str, list[float]] = {name: [] for name in host}
    for _ in range(reps):
        dev_batch = batch.to(trainer.device)
        trainer.optimizer.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        loss = None
        for name in host:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t0 = time.perf_counter()
            ev[0].record()
            if name == "forward":
                loss = batch_loss(trainer.model, dev_batch, trainer.config.train.loss)
            elif name == "backward":
                loss.backward()
            else:
                trainer.optimizer.step()
            ev[1].record()
            torch.cuda.synchronize()
            host[name].append((time.perf_counter() - t0) * 1e3)
            dev[name].append(ev[0].elapsed_time(ev[1]))
    return {n: (statistics.median(host[n]), statistics.median(dev[n])) for n in host}


def training_phase(torch, np, card: str):
    """Phase 6: training at full width through the port's train entry
    point, with the FFN kernel in every forward. Returns the kernel's
    launches over the run, the run's trainer and its peak memory (MiB)."""
    from torch.profiler import ProfilerActivity, profile

    from gnot_tpu_torch import main as port_main
    from gnot_tpu_torch.models import layers
    from gnot_tpu_torch.ops.fused_ffn import (
        fused_gated_ffn_kernel,
        fused_gated_ffn_reference,
        pack_weights,
    )
    from gnot_tpu_torch.train import trainer as trainer_mod
    from gnot_tpu_torch.train.trainer import Trainer, batch_loss

    args = port_main.build_parser().parse_args(TRAIN_ARGV)
    trainer, plain, launches, _, own_mib = held_against_plain(torch, np, port_main, layers,
                                                              TRAIN_ARGV, "train")
    expect_train_launches(trainer, launches, args.epochs, "train")
    log(f"[train] the run's own peak device memory (above what earlier phases hold) "
        f"{own_mib:.1f} MiB")
    cfg = trainer.model_cfg

    # Control: the kernel run again with torch's fused AdamW, which writes
    # the weights without moving their version, so the kernel reads the
    # first step's weight images all run long. What it reads against the
    # plain run shows how far the bar above is from a stale-image fault.
    make_optimizer = trainer_mod.make_optimizer
    trainer_mod.make_optimizer = lambda cfg, params: torch.optim.AdamW(
        params, lr=cfg.lr, betas=(cfg.b1, cfg.b2), eps=cfg.eps,
        weight_decay=cfg.weight_decay, fused=True)
    try:
        stale, _ = train_quietly(port_main, args)
    finally:
        trainer_mod.make_optimizer = make_optimizer
    stale_rel = worst_rel(np, step_losses(np, stale)[1:], step_losses(np, plain)[1:])
    log(f"[train] stale-image control (fused AdamW): steps 2.. worst rel {stale_rel:.3e} vs the "
        f"plain-FFN run, {stale_rel / TRAIN_LATER_RTOL:.1f}x the bar")

    # The kernel on the live weights after the optimizer's last step, and
    # after one more step: every FFN module against the plain version.
    rng = np.random.default_rng(6)
    width = cfg.n_attn_hidden_dim
    x = torch.from_numpy(rng.standard_normal((4, 1024, width), dtype=np.float32)).cuda()
    logits = torch.from_numpy(rng.standard_normal((4, 1024, cfg.n_expert), dtype=np.float32))
    scores = torch.softmax(logits, -1).cuda()
    ffns = [m for m in trainer.model.modules() if isinstance(m, layers.GatedExpertFfn)]
    weights = [([l.kernel for l in f.experts.layers()], [l.bias for l in f.experts.layers()])
               for f in ffns]
    worst = 0.0
    before = []
    for k, b in weights:
        out = fused_gated_ffn_kernel(x, scores, k, b, gelu_kind=cfg.gelu)
        want_out = fused_gated_ffn_reference(x, scores, k, b, gelu_kind=cfg.gelu)
        torch.testing.assert_close(out, want_out, rtol=MODEL_RTOL, atol=MODEL_ATOL)
        worst = max(worst, (out - want_out).abs().max().item())
        before.append(out.clone())
    trainer.train_loader.set_epoch(args.epochs)
    trainer.train_step(next(iter(trainer.train_loader)), trainer.lr_fn(trainer.host_step, args.epochs))
    for (k, b), old in zip(weights, before):
        out = fused_gated_ffn_kernel(x, scores, k, b, gelu_kind=cfg.gelu)
        want_out = fused_gated_ffn_reference(x, scores, k, b, gelu_kind=cfg.gelu)
        if torch.equal(out, old):
            raise RuntimeError("the FFN kernel's output did not move after an AdamW step")
        torch.testing.assert_close(out, want_out, rtol=MODEL_RTOL, atol=MODEL_ATOL)
        worst = max(worst, (out - want_out).abs().max().item())
    log(f"[train] kernel vs plain on the live weights of all {len(ffns)} FFN modules, after the "
        f"run's last step and after one more AdamW step ({type(trainer.optimizer).__name__}, "
        f"foreach={trainer.optimizer.defaults['foreach']}): "
        f"max_abs_err {worst:.3e} (rtol {MODEL_RTOL} atol {MODEL_ATOL}); images repacked")

    # Host-clock step time, the kernel and the torch FFN path in turns.
    times: dict[str, list[float]] = {"pallas": [], "xla": []}
    for impl in ("pallas", "xla", "xla", "pallas"):
        times[impl].append(statistics.median(step_times(torch, Trainer, trainer, impl)[1:]))
    log(f"[train] step time, host clock around each waited-for step, median of steps 2..8, "
        f"turns pallas/xla/xla/pallas: ffn_impl=pallas {times['pallas']} ms, "
        f"ffn_impl=xla {times['xla']} ms on {card}")

    # Where one train step spends its time.
    batch = next(iter(trainer.train_loader))
    lr = trainer.lr_fn(trainer.host_step, args.epochs)
    trainer.train_step(batch, lr)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(batch, lr)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = kernel_rows(prof)
    busy_ms = sum(r[0] for r in rows)
    ffn_ms = sum(r[0] for r in rows if "fused_gated_ffn" in r[2])
    ffn_count = sum(r[1] for r in rows if "fused_gated_ffn" in r[2])
    log(f"[train] one train step: device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall "
        f"({busy_ms / wall_ms:.1%} busy); fused_gated_ffn {ffn_ms:.3f} ms in {ffn_count} launches")
    for ms, count, name in rows[:12]:
        log(f"[train]   {ms:8.3f} ms  x{count:<5d} {name[:90]}")

    # The same step cut into phases, for the kernel path and the torch FFN
    # path, in turns: what the kernel path adds in the forward (the
    # repack) and in the backward (the plain-version recompute of each
    # FFN), on the host clock; and the per-step repack of every expert
    # weight alone.
    kernels = [l.kernel for f in ffns for l in f.experts.layers()]
    repack = lambda: [pack_weights(k.detach()) for k in kernels]  # noqa: E731
    with torch.no_grad():
        pack_ms = device_ms(torch, repack, iters=10)
        pack_host = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            repack()
            torch.cuda.synchronize()
            pack_host.append((time.perf_counter() - t0) * 1e3)
    xla_trainer = fresh_trainer(Trainer, trainer, "xla")
    split: dict[str, list[dict]] = {"pallas": [], "xla": []}
    for impl in ("pallas", "xla", "xla", "pallas"):
        split[impl].append(step_phases(torch, batch_loss, xla_trainer if impl == "xla" else trainer,
                                       batch))
    for impl, runs in split.items():
        log(f"[train] step phases, ffn_impl={impl}, median of 5, host ms / CUDA-event ms, two "
            f"turns: " + "; ".join(
                f"{name} " + " | ".join(f"{r[name][0]:.3f} / {r[name][1]:.3f}" for r in runs)
                for name in runs[0]))
    log(f"[train] repacking the {len(kernels)} expert weights alone: device time {pack_ms:.3f} ms, "
        f"host clock (waited for) {statistics.median(pack_host):.3f} ms; the optimizer is "
        f"{type(trainer.optimizer).__name__}(foreach={trainer.optimizer.defaults['foreach']}, "
        f"fused={trainer.optimizer.defaults['fused']}) over "
        f"{sum(len(g['params']) for g in trainer.optimizer.param_groups)} tensors")
    return launches, trainer, own_mib


def reset_peak(torch) -> float:
    """Wait for the card and restart the peak-memory count; returns the
    MiB allocated now, which earlier phases' models and images hold, so
    that a run's own peak is the new peak less it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 2**20


def step_losses(np, trainer):
    """Every train step's loss of a run, in order, as float64."""
    return np.concatenate([r.step_losses for r in trainer.history]).astype(np.float64)


def worst_rel(np, a, b) -> float:
    """The largest ``|a - b| / |b|`` over the elements."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def bf16_training_phase(torch, np, card: str, f32_trainer, f32_peak_mib: float):
    """Phase 6b: ``--dtype bfloat16`` training at full width through the
    port's train entry point, the counts set to 0 just before and read just
    after; the same run with every FFN through the plain version and with
    its two controls; host-clock step times against f32; peak memory.
    Returns the run's trainer and its launches by dtype mix."""
    import shutil

    from gnot_tpu_torch import main as port_main
    from gnot_tpu_torch.models import layers
    from gnot_tpu_torch.ops.fused_ffn import (
        fused_gated_ffn,
        fused_gated_ffn_kernel,
        fused_gated_ffn_reference,
    )
    from gnot_tpu_torch.train.trainer import Trainer

    shutil.rmtree(TRAIN_OUT, ignore_errors=True)
    argv = TRAIN_ARGV + ["--dtype", "bfloat16", "--checkpoint_dir", str(TRAIN_OUT / "ck_bf16")]
    args = port_main.build_parser().parse_args(argv)
    held_mib = reset_peak(torch)
    fused_gated_ffn_kernel.launches = 0
    fused_gated_ffn_kernel.launches_by_dtype = {}
    t0 = time.perf_counter()
    trainer, lines = train_quietly(port_main, args)
    wall_s = time.perf_counter() - t0
    launches = fused_gated_ffn_kernel.launches
    by_mix = dict(fused_gated_ffn_kernel.launches_by_dtype)
    own_mib = torch.cuda.max_memory_allocated() / 2**20 - held_mib
    log(f"[train-bf16] python -m gnot_tpu_torch.main {' '.join(argv)}: {wall_s:.2f} s")
    for line in lines:
        if line:
            log(f"[train-bf16]   {line}")
    check_reference_lines(lines, args.epochs)
    cfg = trainer.model_cfg
    steps, eval_batches = trainer.host_step, args.epochs * len(trainer.test_loader)
    expected = 2 * cfg.n_attn_layers * (steps + eval_batches)
    log(f"[train-bf16] fused_gated_ffn launches {launches} = 2 x {cfg.n_attn_layers} blocks x "
        f"({steps} train steps + {eval_batches} eval batches), by dtype mix {json.dumps(by_mix)}; "
        f"the run's own peak device memory (above what earlier phases hold) {own_mib:.1f} MiB "
        f"(phase 6, f32: {f32_peak_mib:.1f} MiB)")
    if launches != expected or by_mix != {"bf16-x/f32-w": expected}:
        raise RuntimeError(f"expected {expected} launches of the bf16 training mix, counted "
                           f"{launches} {by_mix}")
    if {p.dtype for p in trainer.model.parameters()} != {torch.float32}:
        raise RuntimeError("bf16 training left a parameter outside f32")

    # The same run through the plain version, and two runs the bar must
    # catch: f32 training (phase 6) and the kernel's serving instance on
    # bf16-cast weights, which skips the lo weight product.
    plain_args = port_main.build_parser().parse_args(TRAIN_ARGV + ["--dtype", "bfloat16"])

    def serving_instance(x, scores, kernels, biases, gelu_kind):
        return fused_gated_ffn(x, scores, [k.bfloat16() for k in kernels],
                               [b.bfloat16() for b in biases], gelu_kind=gelu_kind)

    runs = {}
    matmul = torch.backends.cuda.matmul
    for name, ffn, reduced in (("plain", fused_gated_ffn_reference, True),
                               ("plain, f32 cuBLAS reduction", fused_gated_ffn_reference, False),
                               ("serving instance", serving_instance, True)):
        fused_gated_ffn_kernel.launches = 0
        layers.fused_gated_ffn = ffn
        matmul.allow_bf16_reduced_precision_reduction = reduced
        try:
            runs[name], _ = train_quietly(port_main, plain_args)
        finally:
            layers.fused_gated_ffn = fused_gated_ffn
            matmul.allow_bf16_reduced_precision_reduction = True
        if (fused_gated_ffn_kernel.launches == 0) != name.startswith("plain"):
            raise RuntimeError(f"the {name} run launched the kernel "
                               f"{fused_gated_ffn_kernel.launches} times")
    metrics = lambda t: np.array([r.test_metric for r in t.history])  # noqa: E731
    reading = lambda t, ref: max(worst_rel(np, step_losses(np, t), step_losses(np, ref)),  # noqa: E731
                                 worst_rel(np, metrics(t), metrics(ref)))
    plain = runs["plain"]
    got = reading(trainer, plain)
    exact = reading(trainer, runs["plain, f32 cuBLAS reduction"])
    flag = reading(runs["plain, f32 cuBLAS reduction"], plain)
    controls = {"f32 training (phase 6)": reading(f32_trainer, plain),
                "the serving instance on bf16-cast weights": reading(runs["serving instance"], plain)}
    log(f"[train-bf16] step losses, kernel {step_losses(np, trainer).tolist()}")
    log(f"[train-bf16] step losses, plain  {step_losses(np, plain).tolist()} (0 kernel launches)")
    log(f"[train-bf16] vs the plain-FFN bf16 run, worst relative difference over step losses and "
        f"test metrics: kernel {got:.3e} (bar {BF16_TRAIN_REL}); controls " + ", ".join(
            f"{k} {v:.3e} ({v / BF16_TRAIN_REL:.1f}x the bar)" for k, v in controls.items()))
    log(f"[train-bf16] cuBLAS bf16 GEMMs with reduced-precision reduction off "
        f"(torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction=False; on by "
        f"default): the plain run moves by {flag:.3e}; the kernel run against it {exact:.3e}")
    if got > BF16_TRAIN_REL:
        raise RuntimeError(f"bf16 training through the kernel is {got} from the plain run")
    caught = [k for k, v in controls.items() if v <= BF16_TRAIN_REL]
    if caught:
        raise RuntimeError(f"the bar {BF16_TRAIN_REL} does not catch {caught}")

    # Host-clock step time, f32 and bf16, kernel and torch FFN path, in turns.
    times: dict[tuple[str, str], list[float]] = {}
    order = [("float32", "pallas"), ("bfloat16", "pallas"), ("bfloat16", "xla"), ("float32", "xla")]
    for dtype, impl in order + order[::-1]:
        base = trainer if dtype == "bfloat16" else f32_trainer
        times.setdefault((dtype, impl), []).append(
            statistics.median(step_times(torch, Trainer, base, impl)[1:]))
    log("[train-bf16] step time, host clock around each waited-for step, median of steps 2..8, "
        "two turns each: " + "; ".join(f"{d} ffn_impl={i} {[round(t, 3) for t in v]} ms"
                                       for (d, i), v in times.items()) + f" on {card}")
    return trainer, by_mix


def remat_and_artifacts_phase(torch, np, card: str, f32_peak_mib: float, bf16_trainer) -> None:
    """Phase 6c: one short ``--remat`` run at full width against the same
    run without remat (launches, losses, peak memory); then
    ``--eval_only``, ``--predict_out`` and ``--export_torch`` from phase
    6b's checkpoints, each checked."""
    from gnot_tpu_torch import interop
    from gnot_tpu_torch import main as port_main
    from gnot_tpu_torch.data import datasets
    from gnot_tpu_torch.ops.fused_ffn import fused_gated_ffn_kernel

    short = list(TRAIN_ARGV)
    short[short.index("--epochs") + 1] = "1"
    runs, peaks, counts = {}, {}, {}
    for name, extra in (("remat", ["--remat"]), ("no remat", [])):
        held_mib = reset_peak(torch)
        fused_gated_ffn_kernel.launches = 0
        runs[name], _ = train_quietly(port_main, port_main.build_parser().parse_args(short + extra))
        counts[name] = fused_gated_ffn_kernel.launches
        peaks[name] = torch.cuda.max_memory_allocated() / 2**20 - held_mib
    remat = runs["remat"]
    cfg = remat.model_cfg
    steps, eval_batches = remat.host_step, len(remat.test_loader)
    expected = 2 * cfg.n_attn_layers * (2 * steps + eval_batches)
    rel = worst_rel(np, step_losses(np, remat), step_losses(np, runs["no remat"]))
    log(f"[remat] python -m gnot_tpu_torch.main {' '.join(short)} --remat: fused_gated_ffn "
        f"launches {counts['remat']} = 2 x {cfg.n_attn_layers} blocks x (2 x {steps} train steps "
        f"+ {eval_batches} eval batches), without remat {counts['no remat']}; step losses vs the "
        f"run without remat worst rel {rel:.3e} (bar rtol 1e-5); the run's own peak device "
        f"memory {peaks['remat']:.1f} MiB with remat, {peaks['no remat']:.1f} MiB without "
        f"(phase 6's two-epoch run: {f32_peak_mib:.1f} MiB)")
    if counts["remat"] != expected or not cfg.remat:
        raise RuntimeError(f"expected {expected} launches in the remat run, counted "
                           f"{counts['remat']}")
    np.testing.assert_allclose(step_losses(np, remat), step_losses(np, runs["no remat"]),
                               rtol=1e-5)

    pred, pth = TRAIN_OUT / "pred_bf16.pkl", TRAIN_OUT / "model_bf16.pth"
    argv = TRAIN_ARGV + ["--dtype", "bfloat16", "--checkpoint_dir", str(TRAIN_OUT / "ck_bf16"),
                         "--eval_only", "--predict_out", str(pred), "--export_torch", str(pth)]
    fused_gated_ffn_kernel.launches = 0
    fused_gated_ffn_kernel.launches_by_dtype = {}
    trainer, lines = train_quietly(port_main, port_main.build_parser().parse_args(argv))
    by_mix = dict(fused_gated_ffn_kernel.launches_by_dtype)
    log(f"[artifacts] python -m gnot_tpu_torch.main {' '.join(argv)}")
    for line in lines:
        log(f"[artifacts]   {line}")
    best = bf16_trainer.best_metric
    log(f"[artifacts] eval metric {trainer.best_metric!r} vs phase 6b's best {best!r} "
        f"(bitwise: {trainer.best_metric == best}); fused_gated_ffn launches by dtype mix "
        f"{json.dumps(by_mix)}")
    np.testing.assert_allclose(trainer.best_metric, best, rtol=1e-6)
    eval_line = [line for line in lines if line.startswith("Eval (best checkpoint from epoch ")]
    if len(eval_line) != 1 or list(by_mix) != ["bf16-x/f32-w"]:
        raise RuntimeError(f"eval-only run: lines {lines}, launches {by_mix}")
    records = datasets.load_pickle(str(pred))
    _, test = datasets.load(trainer.config.data)
    if len(records) != len(test) or any(
            r.y.shape != (s.coords.shape[0], cfg.out_dim) or not np.all(np.isfinite(r.y))
            or not np.array_equal(r.coords, s.coords) for r, s in zip(records, test)):
        raise RuntimeError("the prediction pickle does not read back as the test split's "
                           "predictions")
    exported = torch.load(pth, weights_only=True)
    want = interop.reference_state_dict(trainer.model.state_dict(), trainer.model_cfg)
    if sorted(exported) != sorted(want) or any(
            not torch.equal(exported[k], want[k]) for k in want):
        raise RuntimeError("the exported state_dict is not the port's reference naming of the "
                           "best weights")
    log(f"[artifacts] {len(records)} prediction records read back (finite, the test meshes); "
        f"{len(exported)} exported tensors under the reference's names, equal to the best "
        f"checkpoint's weights, on {card}")


def held_against_plain(torch, np, port_main, layers, argv: list[str], tag: str):
    """``run_train`` of ``argv`` with the FFN kernel's counts set to 0 just
    before and read just after, the reference's lines checked, then the
    same run with every FFN through the kernel's plain version (which must
    launch nothing), held step by step to phase 6's bars: step 1 at
    MODEL_RTOL/ATOL, later steps, the test metrics and the best metric at
    TRAIN_LATER_RTOL. Returns the kernel run's trainer, the plain run's,
    the kernel's launches in total and by GELU, and the kernel run's own
    peak device memory (MiB above what earlier phases hold)."""
    from gnot_tpu_torch.ops.fused_ffn import (
        fused_gated_ffn,
        fused_gated_ffn_kernel,
        fused_gated_ffn_reference,
    )

    args = port_main.build_parser().parse_args(argv)
    held_mib = reset_peak(torch)
    fused_gated_ffn_kernel.launches = 0
    fused_gated_ffn_kernel.launches_by_gelu = {}
    t0 = time.perf_counter()
    trainer, lines = train_quietly(port_main, args)
    wall_s = time.perf_counter() - t0
    launches = fused_gated_ffn_kernel.launches
    by_gelu = dict(fused_gated_ffn_kernel.launches_by_gelu)
    own_mib = torch.cuda.max_memory_allocated() / 2**20 - held_mib
    log(f"[{tag}] python -m gnot_tpu_torch.main {' '.join(argv)}: {wall_s:.2f} s")
    for line in lines:
        if line:
            log(f"[{tag}]   {line}")
    check_reference_lines(lines, args.epochs)

    fused_gated_ffn_kernel.launches = 0
    layers.fused_gated_ffn = fused_gated_ffn_reference
    try:
        plain, _ = train_quietly(port_main, args)
    finally:
        layers.fused_gated_ffn = fused_gated_ffn
    if fused_gated_ffn_kernel.launches != 0:
        raise RuntimeError(f"the plain-FFN run launched the kernel "
                           f"{fused_gated_ffn_kernel.launches} times")
    got, want = step_losses(np, trainer), step_losses(np, plain)
    got_m = np.array([r.test_metric for r in trainer.history])
    want_m = np.array([r.test_metric for r in plain.history])
    log(f"[{tag}] step losses, kernel {got.tolist()}")
    log(f"[{tag}] step losses, plain  {want.tolist()} (0 kernel launches)")
    log(f"[{tag}] vs the plain-FFN run: step 1 loss abs diff {abs(got[0] - want[0]):.3e} (bar "
        f"rtol {MODEL_RTOL} atol {MODEL_ATOL}); steps 2..{len(got)} worst rel "
        f"{worst_rel(np, got[1:], want[1:]):.3e}, test metrics worst rel "
        f"{worst_rel(np, got_m, want_m):.3e} (bar rtol {TRAIN_LATER_RTOL})")
    np.testing.assert_allclose(got[0], want[0], rtol=MODEL_RTOL, atol=MODEL_ATOL)
    np.testing.assert_allclose(got[1:], want[1:], rtol=TRAIN_LATER_RTOL)
    np.testing.assert_allclose(got_m, want_m, rtol=TRAIN_LATER_RTOL)
    np.testing.assert_allclose(trainer.best_metric, plain.best_metric, rtol=TRAIN_LATER_RTOL)
    return trainer, plain, launches, by_gelu, own_mib


def expect_train_launches(trainer, launches: int, epochs: int, tag: str) -> int:
    """Fails unless the kernel launched twice per block in every train step
    and every eval forward of the run; returns the expected count."""
    cfg = trainer.model_cfg
    steps, eval_batches = trainer.host_step, epochs * len(trainer.test_loader)
    expected = 2 * cfg.n_attn_layers * (steps + eval_batches)
    log(f"[{tag}] fused_gated_ffn launches {launches} = 2 x {cfg.n_attn_layers} blocks x "
        f"({steps} train steps + {eval_batches} eval forwards)")
    if launches != expected or launches == 0:
        raise RuntimeError(f"expected {expected} FFN kernel launches, counted {launches}")
    return expected


def parity_training_phase(torch, np, card: str) -> int:
    """Phase 7: ``--attention_mode parity`` training at full width through
    the port's train entry point (erf GELU, bucketing off), held against
    the plain-FFN run; then one ragged batch's forward through the parity
    model and through a masked model of the same weights, which must
    differ on every padded sample. Returns the kernel's launches."""
    from gnot_tpu_torch import main as port_main
    from gnot_tpu_torch.data.batch import collate
    from gnot_tpu_torch.models import layers
    from gnot_tpu_torch.models.gnot import GNOT, apply_batch

    trainer, _, launches, by_gelu, _ = held_against_plain(torch, np, port_main, layers,
                                                          PARITY_ARGV, "parity")
    expect_train_launches(trainer, launches, 2, "parity")
    cfg = trainer.model_cfg
    log(f"[parity] launches by GELU {json.dumps(by_gelu)}; the loaders pad to the per-batch max "
        f"(bucket={trainer.train_loader.bucket}); cuBLAS TF32 "
        f"{torch.backends.cuda.matmul.allow_tf32} (JAX's precision_scope: full f32)")
    if (by_gelu != {"erf": launches} or cfg.attention_mode != "parity"
            or trainer.train_loader.bucket or torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(f"parity training ran {by_gelu}, bucket {trainer.train_loader.bucket}, "
                           f"TF32 {torch.backends.cuda.matmul.allow_tf32}")

    # The padding-pollution control: a ragged batch (the test meshes cut to
    # 256, 219, 182 and 145 points) through the parity model, with and
    # without masks, each sample alone (no padding), and through a masked
    # model of the same weights.
    ragged = [dataclasses.replace(s, coords=s.coords[:n], y=s.y[:n])
              for s, n in zip(trainer.test_loader.samples, (256, 219, 182, 145))]
    batch = collate(ragged, bucket=False, device=trainer.device)
    masked = GNOT(dataclasses.replace(cfg, attention_mode="masked")).to(trainer.device)
    masked.load_state_dict(trainer.model.state_dict(), strict=True)
    with torch.no_grad():
        got = apply_batch(trainer.model, batch).cpu().numpy()
        unmasked = trainer.model(batch.coords, batch.theta, batch.funcs).cpu().numpy()
        other = apply_batch(masked, batch).cpu().numpy()
        solo = [apply_batch(trainer.model, collate([s], bucket=False, device=trainer.device))
                .cpu().numpy()[0] for s in ragged]
    real = lambda a, i: a[i, :len(ragged[i].y)]  # noqa: E731
    pollution = [float(np.max(np.abs(real(got, i) - solo[i]))) for i in range(len(ragged))]
    diffs = [float(np.max(np.abs(real(other, i) - real(got, i)))) for i in range(len(ragged))]
    log(f"[parity] ragged batch [4 x 256 points, real 256/219/182/145]: parity with vs without "
        f"masks max abs diff {float(np.max(np.abs(got - unmasked))):.3e}; the padding's "
        f"pollution, batch row vs the sample alone, max abs diff per sample "
        f"{[f'{d:.3e}' for d in pollution]} (the unpadded first within rtol {MODEL_RTOL} atol "
        f"{MODEL_ATOL}, the padded outside it); masked vs parity on the real rows "
        f"{[f'{d:.3e}' for d in diffs]} on {card}")
    if not np.array_equal(got, unmasked) or not np.all(np.isfinite(got)):
        raise RuntimeError("the parity forward depends on the masks it must drop")
    np.testing.assert_allclose(real(got, 0), solo[0], rtol=MODEL_RTOL, atol=MODEL_ATOL)
    for i in range(1, len(ragged)):
        if np.allclose(real(got, i), solo[i], rtol=MODEL_RTOL, atol=MODEL_ATOL):
            raise RuntimeError(f"padded sample {i} equals its solo forward: no pollution")
        if np.allclose(real(other, i), real(got, i), rtol=MODEL_RTOL, atol=MODEL_ATOL):
            raise RuntimeError(f"parity and masked agree on padded sample {i}")
    return launches


def packed_dispatches(samples, plan) -> list[list]:
    """``samples`` in arrival order cut into plan-shaped packed dispatches
    (first-fit prefixes), as the server cuts a backlog."""
    from gnot_tpu_torch.data.batch import pack_prefix

    groups, rest = [], list(samples)
    while rest:
        n = max(1, len(pack_prefix([s.coords.shape[0] for s in rest], plan)))
        groups.append(rest[:n])
        rest = rest[n:]
    return groups


def packed_serving_phase(torch, np, card: str) -> tuple[int, int, dict]:
    """Phase 8: ``--serve --serve_packed`` at full width on ragged
    elasticity traffic, f32 then bf16, each run with the counts set to 0
    just before and read just after; every f32 output against its solo
    padded dispatch; bf16 against f32 and, on the same dispatches, against
    the plain version; host-clock dispatch times packed vs padded on the
    same traffic; the kernel at the packed launch shape. Returns the f32
    and bf16 launches and the packed shape's fields of the kernel entry."""
    from torch.profiler import ProfilerActivity, profile

    from gnot_tpu_torch import main as port_main
    from gnot_tpu_torch.data.batch import pack_collate, pack_prefix
    from gnot_tpu_torch.models import layers
    from gnot_tpu_torch.models.gnot import apply_batch
    from gnot_tpu_torch.ops.fused_ffn import (
        fused_gated_ffn,
        fused_gated_ffn_kernel,
        fused_gated_ffn_reference,
    )
    from gnot_tpu_torch.serve.engine import InferenceEngine

    runs, counts = {}, {}
    for dtype in ("float32", "bfloat16"):
        argv = PACKED_SERVE_ARGV + ["--serve_dtype", dtype]
        fused_gated_ffn_kernel.launches = 0
        fused_gated_ffn_kernel.launches_by_dtype = {}
        runs[dtype] = run = port_main.run_serve(port_main.build_parser().parse_args(argv))
        counts[dtype] = (fused_gated_ffn_kernel.launches,
                         dict(fused_gated_ffn_kernel.launches_by_dtype))
        summary, plan = run.summary, run.pack_plan
        log(f"[serve-packed] python -m gnot_tpu_torch.main {' '.join(argv)}")
        log(f"[serve-packed] summary {json.dumps(summary)}")
        n_ok = sum(r.ok for r in run.results)
        if n_ok != len(run.results) or len(run.results) != 16:
            raise RuntimeError(f"{n_ok}/{len(run.results)} packed requests ok: "
                               f"{[(r.reason, r.detail) for r in run.results if not r.ok]}")
        cfg = run.model.config
        dispatches = summary["dispatches"] + summary["warmed_buckets"]
        expected = 2 * cfg.n_attn_layers * dispatches
        packed = summary["pad_waste_by_bucket"].get(f"packed:{plan.n_rows}x{plan.row_len}", {})
        launches, by_dtype = counts[dtype]
        mix = "f32" if dtype == "float32" else "bf16"
        log(f"[serve-packed] {dtype}: {n_ok}/16 ok; plan {plan.n_rows} rows x {plan.row_len} "
            f"tokens (chunk {plan.chunk}, {plan.n_slots} slots, functions padded to "
            f"{plan.pad_funcs}); {packed.get('dispatches', 0)} packed dispatches carrying "
            f"{packed.get('real_tokens', 0)} real of {packed.get('capacity_tokens', 0)} capacity "
            f"tokens (fill {packed.get('fill_frac', 0):.1%}); fused_gated_ffn launches {launches} "
            f"= 2 x {cfg.n_attn_layers} blocks x {dispatches} dispatches ({summary['dispatches']} "
            f"served + {summary['warmed_buckets']} warm-up), by dtype {json.dumps(by_dtype)}")
        if launches != expected or not packed.get("dispatches") or by_dtype != {mix: launches}:
            raise RuntimeError(f"expected {expected} {mix} launches over packed dispatches, "
                               f"counted {launches} {by_dtype}, packed {packed}")

    f32, bf16 = runs["float32"], runs["bfloat16"]
    plan = f32.pack_plan
    engine = InferenceEngine(f32.model, batch_size=4)
    worst = 0.0
    for r, s in zip(f32.results, f32.samples):
        key = engine.bucket_key(s)
        solo = engine.infer([s], pad_nodes=key[0], pad_funcs=key[1], rows=4)[0]
        if r.output.shape != solo.shape or not np.all(np.isfinite(r.output)):
            raise RuntimeError(f"bad packed output {r.output.shape} vs {solo.shape}")
        np.testing.assert_allclose(r.output, solo, rtol=SOLO_RTOL, atol=SOLO_ATOL)
        worst = max(worst, float(np.max(np.abs(r.output - solo))))
    log(f"[serve-packed] f32 outputs vs each request's solo padded dispatch: max_abs_err "
        f"{worst:.3e} (bar rtol {SOLO_RTOL} atol {SOLO_ATOL})")

    # bf16: per request against the f32 packed server; then kernel against
    # plain version on the same dispatches, with the ffn_impl=xla control.
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))  # noqa: E731
    f32_rels = [rel(r.output, w.output) for r, w in zip(bf16.results, f32.results)]
    groups = packed_dispatches(bf16.samples, plan)
    eng16 = InferenceEngine(bf16.model, batch_size=4, dtype="bfloat16")
    serve16 = lambda eng: np.concatenate(  # noqa: E731
        [o for g in groups for o in eng.infer_packed(g, plan)])
    kernel_out = serve16(eng16)
    layers.fused_gated_ffn = fused_gated_ffn_reference
    try:
        plain_out = serve16(eng16)
    finally:
        layers.fused_gated_ffn = fused_gated_ffn
    cfg = bf16.model.config
    with torch.device("meta"):
        xla_model = type(bf16.model)(dataclasses.replace(cfg, ffn_impl="xla"))
    xla_model.load_state_dict(bf16.model.state_dict(), strict=True, assign=True)
    control = serve16(InferenceEngine(xla_model.eval(), batch_size=4, dtype="bfloat16"))
    plain_rel, control_rel = rel(kernel_out, plain_out), rel(control, plain_out)
    log(f"[serve-packed] bf16 vs the f32 packed server per request: max {max(f32_rels):.3e} "
        f"median {statistics.median(f32_rels):.3e} (bar {BF16_F32_REL}); on the same "
        f"{len(groups)} packed dispatches, kernel vs plain version relative norm {plain_rel:.3e} "
        f"(bar {BF16_PLAIN_REL}), the control (ffn_impl=xla in bf16) {control_rel:.3e}, "
        f"{control_rel / BF16_PLAIN_REL:.1f}x the bar")
    if max(f32_rels) >= BF16_F32_REL or plain_rel > BF16_PLAIN_REL or control_rel <= BF16_PLAIN_REL:
        raise RuntimeError(f"bf16 packed serving off its bars: {max(f32_rels)} vs f32, "
                           f"{plain_rel} vs plain, control {control_rel}")

    # The pad tail of a packed forward is finite.
    first = groups[0]
    placements = pack_prefix([s.coords.shape[0] for s in first], plan)
    pb = pack_collate(first, placements, n_rows=plan.n_rows, row_len=plan.row_len,
                      chunk=plan.chunk, n_slots=plan.n_slots, pad_funcs=plan.pad_funcs,
                      device=engine.device)
    with torch.no_grad():
        out = apply_batch(engine.model, pb)
    pad = pb.node_mask == 0
    if not torch.isfinite(out).all():
        raise RuntimeError("the packed forward is not finite in the pad tail")
    log(f"[serve-packed] one packed forward [{plan.n_rows}x{plan.row_len}], "
        f"{int(pad.sum())} pad tokens: every output finite")

    # Host-clock dispatch time on the same traffic: packed dispatches vs the
    # padded per-bucket dispatches (4 rows each), in turns.
    buckets: dict = {}
    for s in f32.samples:
        buckets.setdefault(engine.bucket_key(s), []).append(s)
    padded = [(key, g[i:i + 4]) for key, g in buckets.items() for i in range(0, len(g), 4)]
    paths = {
        "padded": lambda: [engine.infer(g, pad_nodes=k[0], pad_funcs=k[1], rows=4)
                           for k, g in padded],
        "packed": lambda: [engine.infer_packed(g, plan) for g in groups],
    }
    times: dict[str, list[float]] = {"padded": [], "packed": []}
    for label in ("padded", "packed", "packed", "padded"):
        paths[label]()
        reps = []
        for _ in range(5):
            t0 = time.perf_counter()
            paths[label]()  # each dispatch ends in a device-to-host copy
            reps.append((time.perf_counter() - t0) * 1e3)
        times[label].append(statistics.median(reps))
    busy = {}
    for label, fn in paths.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
        rows = kernel_rows(prof)
        ffn = [r for r in rows if "fused_gated_ffn" in r[2]]
        busy[label] = (sum(r[0] for r in rows), sum(r[1] for r in rows),
                       sum(r[0] for r in ffn), sum(r[1] for r in ffn))
    log("[serve-packed] device busy for all 16 requests: " + "; ".join(
        f"{label} {b[0]:.3f} ms in {b[1]} kernels, fused_gated_ffn {b[2]:.3f} ms in {b[3]} "
        f"launches" for label, b in busy.items()))
    real = sum(s.coords.shape[0] for s in f32.samples)
    padded_capacity = sum(4 * k[0] for k, _ in padded)
    log(f"[serve-packed] the 16 requests ({real} real tokens): {len(groups)} packed dispatches "
        f"of {plan.capacity_tokens} tokens ({real / (len(groups) * plan.capacity_tokens):.1%} "
        f"full) vs {len(padded)} padded dispatches of {padded_capacity} tokens in all "
        f"({real / padded_capacity:.1%} full); host clock for all of them, median of 5, turns "
        f"padded/packed/packed/padded: padded {[round(t, 3) for t in times['padded']]} ms, "
        f"packed {[round(t, 3) for t in times['packed']]} ms on {card}")

    # The kernel at the packed launch shape, pad rows zero, against its
    # plain version; then its device time beside its bound.
    x, scores, kernels, biases = ffn_inputs(torch, np, plan.n_rows, plan.row_len, 256, 3, 5,
                                            seed=11)
    x = x * pb.node_mask[..., None]
    max_abs = 0.0
    for gelu in ("tanh", "erf"):
        got = fused_gated_ffn_kernel(x, scores, kernels, biases, gelu_kind=gelu)
        want = fused_gated_ffn_reference(x, scores, kernels, biases, gelu_kind=gelu)
        torch.cuda.synchronize()
        if not torch.isfinite(got[pad]).all():
            raise RuntimeError("the kernel's pad-row outputs are not finite")
        torch.testing.assert_close(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
        max_abs = max(max_abs, (got - want).abs().max().item())
    with torch.inference_mode():
        kernel_ms = device_ms(torch, lambda: fused_gated_ffn_kernel(x, scores, kernels, biases,
                                                                    gelu_kind="tanh"))
        plain_ms = device_ms(torch, lambda: fused_gated_ffn_reference(x, scores, kernels, biases,
                                                                      gelu_kind="tanh"))
    bound_ms, bound_by = ffn_bound_ms(x, scores, kernels, biases)
    shape = [plan.n_rows, plan.row_len, 256]
    log(f"[serve-packed] kernel at the packed launch shape x {shape} E=3 5 Linears, pad rows "
        f"zero: max_abs_err {max_abs:.3e} vs the plain version (rtol {KERNEL_RTOL} atol "
        f"{KERNEL_ATOL}), pad-row outputs finite; device time kernel {kernel_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / kernel_ms:.1%} "
        f"of bound on {card}")
    fields = dict(packed_shape=shape, packed_ms=kernel_ms, packed_plain_ms=plain_ms,
                  packed_bound_ms=bound_ms, packed_max_abs_err=max_abs)
    return counts["float32"][0], counts["bfloat16"][0], fields


def packed_training_phase(torch, np, card: str) -> int:
    """Phase 9: ``--packed`` training at full width on ragged elasticity,
    held against the plain-FFN run, its final test metric against the
    unpacked run of the same data (rtol PACKED_EVAL_RTOL), and host-clock
    step times packed vs unpacked. Returns the kernel's launches."""
    from gnot_tpu_torch import main as port_main
    from gnot_tpu_torch.data.batch import PackedLoader
    from gnot_tpu_torch.models import layers
    from gnot_tpu_torch.train.trainer import Trainer

    trainer, _, launches, _, packed_mib = held_against_plain(
        torch, np, port_main, layers, PACKED_TRAIN_ARGV, "train-packed")
    loader = trainer.train_loader
    if not isinstance(loader, PackedLoader) or not isinstance(trainer.test_loader, PackedLoader):
        raise RuntimeError("--packed training did not take the packed loaders")
    expect_train_launches(trainer, launches, 2, "train-packed")
    unpacked_argv = [a for a in PACKED_TRAIN_ARGV if a != "--packed"]
    held_mib = reset_peak(torch)
    unpacked, _ = train_quietly(port_main, port_main.build_parser().parse_args(unpacked_argv))
    unpacked_mib = torch.cuda.max_memory_allocated() / 2**20 - held_mib
    got, want = trainer.history[-1].test_metric, unpacked.history[-1].test_metric
    log(f"[train-packed] dispatches of {loader.n_rows} rows x {loader.row_len} tokens (chunk "
        f"{loader.chunk}, {loader.n_slots} slots); {trainer.host_step} packed steps vs "
        f"{unpacked.host_step} padded; final test metric packed {got!r} vs unpacked {want!r}, "
        f"rel {abs(got - want) / abs(want):.3e} (bar rtol {PACKED_EVAL_RTOL}); each run's own "
        f"peak device memory (above what earlier phases hold) packed {packed_mib:.1f} MiB, "
        f"unpacked {unpacked_mib:.1f} MiB")
    np.testing.assert_allclose(got, want, rtol=PACKED_EVAL_RTOL)

    times: dict[str, list[float]] = {"packed": [], "unpacked": []}
    for label in ("packed", "unpacked", "unpacked", "packed"):
        base = trainer if label == "packed" else unpacked
        times[label].append(statistics.median(step_times(torch, Trainer, base, "pallas")[1:]))
    log(f"[train-packed] step time, host clock around each waited-for step, median of steps "
        f"2.., turns packed/unpacked/unpacked/packed: packed {[round(t, 3) for t in times['packed']]}"
        f" ms, unpacked {[round(t, 3) for t in times['unpacked']]} ms on {card}")
    return launches


def loop_epoch_ms(torch, trainer_cls, trainer, k: int, epochs: int = 3) -> list[float]:
    """Host-clock ms per train step of a fresh trainer of ``trainer``'s run
    over ``epochs`` epochs, ``k`` steps per dispatch (``k`` 1: one
    ``train_step`` per batch), the card waited for only at each epoch's
    end: the epoch's steps timed together, divided by their count."""
    from gnot_tpu_torch.train.trainer import group_batches, stack_batches

    fresh = fresh_trainer(trainer_cls, trainer, trainer.model_cfg.ffn_impl)
    times = []
    for epoch in range(epochs):
        fresh.train_loader.set_epoch(epoch)
        batches = list(fresh.train_loader)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for kind, item in group_batches(batches, k):
            if kind == "group":
                lrs = [fresh.lr_fn(fresh.host_step + i, epoch) for i in range(len(item))]
                fresh.multi_train_step(stack_batches(item, pin_memory=True), lrs)
            else:
                fresh.train_step(item, fresh.lr_fn(fresh.host_step, epoch))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / len(batches))
    return times


def optimizer_kernels(torch, trainer) -> tuple[int, float]:
    """CUDA kernels of one ``optimizer.step()`` (``torch.profiler``) after
    one forward and backward of the trainer's first batch, and the step's
    host-clock ms, waited for, median of 5 unprofiled steps."""
    from torch.profiler import ProfilerActivity, profile

    from gnot_tpu_torch.train.trainer import batch_loss

    batch = next(iter(trainer.train_loader)).to(trainer.device)
    if trainer.flat is not None:
        trainer.flat.zero_grad()
    else:
        trainer.optimizer.zero_grad(set_to_none=True)
    batch_loss(trainer.model, batch, trainer.config.train.loss).backward()
    host = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.optimizer.step()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    count = 0
    for _ in range(3):  # a profile CUPTI hands back empty is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            trainer.optimizer.step()
            torch.cuda.synchronize()
        count = sum(evt.count for evt in prof.key_averages()
                    if str(getattr(evt, "device_type", "")).endswith("CUDA"))
        if count:
            break
    return count, statistics.median(host[1:])


def live_weights_check(torch, np, layers, trainer, tag: str) -> float:
    """The stale-image control of a layout: the kernel against its plain
    version on the live weights of every FFN module after the run's last
    step, then after one more step, where every output must have moved.
    Returns the worst absolute difference."""
    from gnot_tpu_torch.ops.fused_ffn import fused_gated_ffn_kernel, fused_gated_ffn_reference

    cfg = trainer.model_cfg
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.standard_normal((4, 1024, cfg.n_attn_hidden_dim),
                                             dtype=np.float32)).cuda()
    logits = torch.from_numpy(rng.standard_normal((4, 1024, cfg.n_expert), dtype=np.float32))
    scores = torch.softmax(logits, -1).cuda()
    ffns = [m for m in trainer.model.modules() if isinstance(m, layers.GatedExpertFfn)]
    weights = [([l.kernel for l in f.experts.layers()], [l.bias for l in f.experts.layers()])
               for f in ffns]
    worst, before = 0.0, []
    for step in range(2):
        if step:
            trainer.train_loader.set_epoch(1)
            trainer.train_step(next(iter(trainer.train_loader)), trainer.lr_fn(trainer.host_step, 1))
        for i, (k, b) in enumerate(weights):
            out = fused_gated_ffn_kernel(x, scores, k, b, gelu_kind=cfg.gelu)
            want = fused_gated_ffn_reference(x, scores, k, b, gelu_kind=cfg.gelu)
            torch.testing.assert_close(out, want, rtol=MODEL_RTOL, atol=MODEL_ATOL)
            worst = max(worst, (out - want).abs().max().item())
            if step == 0:
                before.append(out.clone())
            elif torch.equal(out, before[i]):
                raise RuntimeError(f"[{tag}] the FFN kernel's output did not move after a step")
    log(f"[{tag}] kernel vs plain on the live weights of all {len(ffns)} FFN modules after the "
        f"run's last step and after one more: max_abs_err {worst:.3e} (rtol {MODEL_RTOL} atol "
        f"{MODEL_ATOL}); every output moved with the weights")
    return worst


def training_loop_phase(torch, np, card: str) -> dict[str, int]:
    """Phase 10: gradient accumulation, K steps per dispatch, the flat and
    the stacked layouts at full width through the port's train entry
    point, one epoch each. Returns the FFN kernel's launches of the
    accumulation, K-step and flat runs."""
    from gnot_tpu_torch import main as port_main
    from gnot_tpu_torch.models import layers
    from gnot_tpu_torch.ops import fused_ffn
    from gnot_tpu_torch.train.trainer import Trainer

    counts = {}
    n_kernels = lambda t: sum(len(f.experts.layers()) for f in t.model.modules()  # noqa: E731
                              if isinstance(f, layers.GatedExpertFfn))

    # (a) --grad_accum 2: held against the plain-FFN run of the same flags;
    # the weight images packed once per update.
    argv = LOOP_ARGV + ["--grad_accum", "2"]
    accum, _, launches, _, _ = held_against_plain(torch, np, port_main, layers, argv, "accum")
    counts["accum_train_launches"] = launches
    expect_train_launches(accum, launches, 1, "accum")
    if (accum.mini_step, accum.gradient_step) != (0, accum.host_step // 2):
        raise RuntimeError(f"[accum] {accum.host_step} micro-steps made "
                           f"{accum.gradient_step} updates, mini_step {accum.mini_step}")
    fresh = fresh_trainer(Trainer, accum, "pallas")
    packs = []
    for batch in fresh.train_loader:
        before = fused_ffn.packed_weights.packs
        fresh.train_step(batch, fresh.lr_fn(fresh.host_step, 0))
        packs.append(fused_ffn.packed_weights.packs - before)
    want = [n_kernels(fresh) if i % 2 == 0 else 0 for i in range(len(packs))]
    log(f"[accum] weight images packed per micro-step {packs} (expected {want}: every expert "
        f"weight on the first micro-step after each update, none on the others); "
        f"{fresh.gradient_step} updates")
    if packs != want:
        raise RuntimeError(f"[accum] packs per micro-step {packs}, expected {want}")

    # (b) --steps_per_dispatch 4 against K=1: bitwise.
    runs = {}
    for k in (1, 4):
        argv = LOOP_ARGV + (["--steps_per_dispatch", str(k)] if k > 1 else [])
        fused_ffn.fused_gated_ffn_kernel.launches = 0
        trainer, lines = train_quietly(port_main, port_main.build_parser().parse_args(argv))
        check_reference_lines(lines, 1)
        runs[k] = (trainer, fused_ffn.fused_gated_ffn_kernel.launches)
    (one, one_launches), (four, four_launches) = runs[1], runs[4]
    counts["dispatch_train_launches"] = four_launches
    expect_train_launches(four, four_launches, 1, "dispatch")
    bitwise = (np.array_equal(step_losses(np, one), step_losses(np, four))
               and [r.test_metric for r in one.history] == [r.test_metric for r in four.history]
               and all(torch.equal(p, four.model.state_dict()[n])
                       for n, p in one.model.state_dict().items()))
    log(f"[dispatch] K=4 step losses {step_losses(np, four).tolist()}, test metric "
        f"{four.history[-1].test_metric!r}; K=1 {step_losses(np, one).tolist()}, "
        f"{one.history[-1].test_metric!r}: bitwise equal (losses, metric, every weight) "
        f"{bitwise}")
    if not bitwise or one_launches != four_launches:
        raise RuntimeError(f"[dispatch] K=4 is not the K=1 run bitwise ({one_launches} vs "
                           f"{four_launches} launches)")
    times: dict[int, list[float]] = {1: [], 4: []}
    for k in (1, 4, 4, 1):
        times[k].append(statistics.median(loop_epoch_ms(torch, Trainer, four, k)))
    log(f"[dispatch] step time, host clock, an epoch's 4 steps timed together (median of 3 "
        f"epochs), turns K=1/K=4/K=4/K=1: K=1 {[round(t, 3) for t in times[1]]} ms, K=4 "
        f"{[round(t, 3) for t in times[4]]} ms on {card}")

    # (c) --flat_params against the tree layout (the K=1 run above).
    fused_ffn.fused_gated_ffn_kernel.launches = 0
    flat, lines = train_quietly(port_main, port_main.build_parser().parse_args(
        LOOP_ARGV + ["--flat_params"]))
    check_reference_lines(lines, 1)
    counts["flat_train_launches"] = fused_ffn.fused_gated_ffn_kernel.launches
    expect_train_launches(flat, counts["flat_train_launches"], 1, "flat")
    misaligned = [n for n, p in flat.model.named_parameters() if p.data_ptr() % 16]
    if misaligned or flat.flat is None:
        raise RuntimeError(f"[flat] not the flat layout, or misaligned weights {misaligned}")
    got, want = step_losses(np, flat), step_losses(np, one)
    got_m = np.array([r.test_metric for r in flat.history])
    want_m = np.array([r.test_metric for r in one.history])
    tree_params = one.model.state_dict()
    same = (np.array_equal(got, want) and np.array_equal(got_m, want_m)
            and all(torch.equal(p, tree_params[n]) for n, p in flat.standard_params().items()))
    log(f"[flat] {flat.flat.layout.size} f32 in one buffer ({len(flat.flat.layout.names)} "
        f"leaves, each at a multiple of 4 elements); vs the tree layout: step 1 loss abs diff "
        f"{abs(got[0] - want[0]):.3e}, steps 2.. worst rel {worst_rel(np, got[1:], want[1:]):.3e}, "
        f"test metric rel {worst_rel(np, got_m, want_m):.3e} (bars of phase 6); bitwise equal "
        f"(losses, metric, every weight) {same}")
    np.testing.assert_allclose(got[0], want[0], rtol=MODEL_RTOL, atol=MODEL_ATOL)
    np.testing.assert_allclose(got[1:], want[1:], rtol=TRAIN_LATER_RTOL)
    np.testing.assert_allclose(got_m, want_m, rtol=TRAIN_LATER_RTOL)
    opt = {}
    for label, t in (("tree", one), ("flat", flat), ("flat", flat), ("tree", one)):
        opt.setdefault(label, []).append(optimizer_kernels(torch, t))
    log(f"[flat] one optimizer.step() (torch.profiler, turns tree/flat/flat/tree): tree "
        f"{[c for c, _ in opt['tree']]} CUDA kernels over "
        f"{sum(len(g['params']) for g in one.optimizer.param_groups)} tensors, "
        f"{[round(ms, 3) for _, ms in opt['tree']]} ms host clock (median of 5); flat "
        f"{[c for c, _ in opt['flat']]} kernels over 1 tensor, "
        f"{[round(ms, 3) for _, ms in opt['flat']]} ms")
    live_weights_check(torch, np, layers, flat, "flat")
    times = {"tree": [], "flat": []}
    for label in ("tree", "flat", "flat", "tree"):
        base = flat if label == "flat" else one
        times[label].append(statistics.median(step_times(torch, Trainer, base, "pallas")[1:]))
    log(f"[flat] step time, host clock around each waited-for step, median of steps 2..8, "
        f"turns tree/flat/flat/tree: tree {[round(t, 3) for t in times['tree']]} ms, flat "
        f"{[round(t, 3) for t in times['flat']]} ms on {card}")

    # (d) --scan_layers --ffn_impl xla against the standard xla run.
    scan_runs = {}
    for scan in (False, True):
        argv = [a for a in LOOP_ARGV if a not in ("--ffn_impl", "pallas")] + ["--ffn_impl", "xla"]
        fused_ffn.fused_gated_ffn_kernel.launches = 0
        trainer, lines = train_quietly(port_main, port_main.build_parser().parse_args(
            argv + (["--scan_layers"] if scan else [])))
        check_reference_lines(lines, 1)
        if fused_ffn.fused_gated_ffn_kernel.launches:
            raise RuntimeError("an ffn_impl=xla run launched the FFN kernel")
        scan_runs[scan] = trainer
    std, scan = scan_runs[False], scan_runs[True]
    if scan.state_dict()["model"].get("blocks.ffn1.experts.dense_0.kernel") is None:
        raise RuntimeError("--scan_layers did not train the stacked layout")
    got, want = step_losses(np, scan), step_losses(np, std)
    got_m = np.array([r.test_metric for r in scan.history])
    want_m = np.array([r.test_metric for r in std.history])
    log(f"[scan] stacked vs standard (ffn_impl=xla): step losses worst rel "
        f"{worst_rel(np, got, want):.3e}, test metric rel {worst_rel(np, got_m, want_m):.3e} "
        f"(bar rtol {SCAN_RTOL}); bitwise {np.array_equal(got, want) and np.array_equal(got_m, want_m)}")
    np.testing.assert_allclose(got, want, rtol=SCAN_RTOL)
    np.testing.assert_allclose(got_m, want_m, rtol=SCAN_RTOL)
    return counts


def run_observed(port_main, argv: list[str]):
    """``port_main.run`` (the command line's run, with its sink, tracer and
    manifest) with its console lines captured: (result, lines)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = port_main.run(argv)
    return result, out.getvalue().splitlines()


def read_jsonl(path) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def span_counts(path) -> dict[str, dict[tuple, int]]:
    """Per trace id of a Chrome trace file: how many spans of each (name,
    parent's name) it holds."""
    spans = json.load(open(path))["traceEvents"]
    by_id = {e["args"]["span_id"]: e for e in spans}
    out: dict[str, dict[tuple, int]] = {}
    for e in spans:
        parent = e["args"].get("parent_id")
        key = (e["name"], by_id[parent]["name"] if parent else None)
        counts = out.setdefault(e["args"]["trace_id"], {})
        counts[key] = counts.get(key, 0) + 1
    return out


def profile_kernel_records(events: list[dict], name: str) -> list[dict]:
    """The kernel records of ``name`` in a ``torch.profiler`` Chrome trace."""
    return [e for e in events if "kernel" in str(e.get("cat", "")).lower()
            and name in str(e.get("name", ""))]


def observed_argv(name: str) -> tuple[list[str], Path]:
    """Phase 6's command with --telemetry --log_every 1 and the metrics,
    trace and profile paths in ``TRAIN_OUT/obs/<name>``."""
    d = TRAIN_OUT / "obs" / name
    return TRAIN_ARGV + OBS_FLAGS + ["--metrics_path", str(d / "m.jsonl"), "--trace_path",
                                     str(d / "t.json"), "--profile_dir", str(d / "prof")], d


def observability_phase(torch, np, card: str, plain_trainer, plain_launches: int) -> dict:
    """Phase 11: phase 6's training with the observability plane on, through
    the port's command-line run, the FFN kernel in every instrumented step;
    then the plane's costs and the NaN watchdog; then phase 4's serving
    traffic with a sink and a tracer. Returns the FFN kernel's launches over
    the instrumented training run and the observed serving run."""
    import shutil
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from gnot_tpu_torch import main as port_main
    from gnot_tpu_torch.models import layers
    from gnot_tpu_torch.obs import events, tracing
    from gnot_tpu_torch.obs.telemetry import TelemetryBuffer, adamw_update_norm, global_norm
    from gnot_tpu_torch.ops.fused_ffn import (
        fused_gated_ffn,
        fused_gated_ffn_kernel,
        fused_gated_ffn_reference,
    )
    from gnot_tpu_torch.train.trainer import Trainer
    from gnot_tpu_torch.utils.profiling import trace_path

    shutil.rmtree(TRAIN_OUT / "obs", ignore_errors=True)

    # (1) The instrumented run, the kernel's count set to 0 just before it.
    argv, out = observed_argv("kernel")
    fused_gated_ffn_kernel.launches = 0
    t0 = time.perf_counter()
    trainer, lines = run_observed(port_main, argv)
    wall_s = time.perf_counter() - t0
    launches = fused_gated_ffn_kernel.launches
    log(f"[obs] python -m gnot_tpu_torch.main {' '.join(argv)}: {wall_s:.2f} s")
    for line in lines:
        if line and not line.startswith("USDT"):
            log(f"[obs]   {line}")
    check_reference_lines(lines, 2)
    cfg = trainer.model_cfg
    n_blocks = cfg.n_attn_layers
    recs = read_jsonl(out / "m.jsonl")
    invalid = [(r, p) for r in recs if (p := events.validate_record(r))]
    steps = [r for r in recs if "grad_norm" in r]
    keys = set(TELEMETRY_KEYS) | {f"gate_{k}/block_{i}" for k in ("load", "entropy")
                                  for i in range(n_blocks)}
    incomplete = [r["step"] for r in steps if not keys <= set(r)]
    gate_err = max(abs(sum(r[f"gate_load/block_{i}"]) - 1.0)
                   for r in steps for i in range(n_blocks))
    kinds = sorted({r.get("event", "step" if "grad_norm" in r else "epoch") for r in recs})
    log(f"[obs] {len(recs)} records {kinds}: {len(steps)} step records with all "
        f"{len(keys)} keys ({sorted(keys - set(TELEMETRY_KEYS))[:2]} ...), every record valid "
        f"{not invalid}; gate_load sums to 1 within {gate_err:.2e} (bar {GATE_SUM_ATOL})")
    log(f"[obs] step 1 record: {json.dumps({k: v for k, v in steps[0].items() if k != 'ts'})}")
    if (invalid or incomplete or [r["step"] for r in steps] != list(range(1, trainer.host_step + 1))
            or gate_err > GATE_SUM_ATOL):
        raise RuntimeError(f"[obs] bad records: invalid {invalid[:2]}, incomplete {incomplete}, "
                           f"steps {[r['step'] for r in steps]}, gate sum error {gate_err}")
    n_steps, n_eval = len(trainer.train_loader), len(trainer.test_loader)
    want_tree = {("epoch", None): 1, ("data_iter", "epoch"): n_steps, ("step", "epoch"): n_steps,
                 ("host_to_device", "step"): n_steps, ("step_dispatch", "step"): n_steps,
                 ("telemetry_drain", "epoch"): 1, ("eval", "epoch"): 1}
    trees = span_counts(out / "t.json")
    wrote = [line for line in lines if line.startswith("Wrote ")]
    n_spans = sum(sum(c.values()) for c in trees.values())
    log(f"[obs] trace: {len(trees)} epoch traces, each "
        f"{sorted(f'{n}<{p}:{c}' for (n, p), c in next(iter(trees.values())).items())}; "
        f"{wrote}")
    if (len(trees) != 2 or any(t != want_tree for t in trees.values())
            or wrote != [line for line in wrote if line.startswith(f"Wrote {n_spans} spans to ")]
            or len(wrote) != 1):
        raise RuntimeError(f"[obs] the span tree {trees} is not {want_tree}, or {wrote}")
    prof = json.load(open(trace_path(str(out / "prof"), 1)))["traceEvents"]
    ffn_records = profile_kernel_records(prof, "fused_gated_ffn")
    ranges = sum(e.get("name") == "step_dispatch" for e in prof)
    want_records = 2 * n_blocks * (n_steps + n_eval)
    log(f"[obs] profile of epoch 1 ({len(prof)} events): {len(ffn_records)} fused_gated_ffn "
        f"kernel records, expected 2 x {n_blocks} blocks x ({n_steps} steps + {n_eval} eval "
        f"forwards) = {want_records}; {ranges} step_dispatch ranges from the tracer")
    if not ffn_records or len(ffn_records) > want_records:
        raise RuntimeError(f"[obs] the profile holds {len(ffn_records)} FFN kernel records")
    if len(ffn_records) < want_records:
        log(f"[profiler] CUPTI kept {len(ffn_records)} records of fused_gated_ffn over "
            f"{want_records} launches: records lost")
    manifest = json.load(open(out / "run.json"))
    log(f"[obs] run.json: kind {manifest['kind']}, devices {manifest['devices']}, versions "
        f"{manifest['versions']}, compile_cache {manifest['compile_cache']}")
    if manifest["devices"]["device_kind"] != torch.cuda.get_device_name(0):
        raise RuntimeError(f"[obs] run.json names {manifest['devices']}")

    # (2) The kernel in every instrumented step: phase 6's count.
    expect_train_launches(trainer, launches, 2, "obs")
    if launches != plain_launches:
        raise RuntimeError(f"[obs] {launches} launches, phase 6 counted {plain_launches}")

    # (3) Telemetry does not change training: phase 6's run, bitwise.
    got, want = step_losses(np, trainer), step_losses(np, plain_trainer)
    same = (np.array_equal(got, want) and [r.test_metric for r in trainer.history]
            == [r.test_metric for r in plain_trainer.history])
    log(f"[obs] step losses {got.tolist()}: bitwise phase 6's run without the flags {same}")
    if not same:
        raise RuntimeError(f"[obs] telemetry changed training: {got} vs {want}")

    # (4) The telemetry values against the same run with every FFN through
    # the kernel's plain version, at phase 6's bars (an atol for the later
    # steps' values near 0).
    plain_argv, plain_out = observed_argv("plain")
    fused_gated_ffn_kernel.launches = 0
    layers.fused_gated_ffn = fused_gated_ffn_reference
    try:
        run_observed(port_main, plain_argv)
    finally:
        layers.fused_gated_ffn = fused_gated_ffn
    if fused_gated_ffn_kernel.launches:
        raise RuntimeError("[obs] the plain-FFN run launched the kernel")
    plain_steps = [r for r in read_jsonl(plain_out / "m.jsonl") if "grad_norm" in r]
    worst: dict[str, float] = {}
    for got_r, want_r in zip(steps, plain_steps, strict=True):
        rtol, atol = ((MODEL_RTOL, MODEL_ATOL) if got_r["step"] == 1
                      else (TRAIN_LATER_RTOL, MODEL_ATOL))
        for key in sorted(keys - {"step", "epoch"}):
            a, b = np.asarray(got_r[key], np.float64), np.asarray(want_r[key], np.float64)
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=f"[obs] step {got_r['step']} {key}")
            rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))
            base = key.split("/")[0]
            worst[base] = max(worst.get(base, 0.0), rel)
    log(f"[obs] telemetry vs the plain-FFN run (0 kernel launches), worst rel per key over "
        f"{len(steps)} steps: {json.dumps({k: float(f'{v:.3e}') for k, v in worst.items()})} "
        f"(bars: step 1 rtol {MODEL_RTOL} atol {MODEL_ATOL}; later rtol {TRAIN_LATER_RTOL} "
        f"atol {MODEL_ATOL})")

    # (5) No host sync added: the synchronizing calls torch reports over the
    # steps between two drains, with and without telemetry.
    batches = list(trainer.train_loader)

    def fresh(with_telemetry: bool, log_every: int = 1000):
        t = fresh_trainer(Trainer, trainer, "pallas")
        if with_telemetry:
            t._telemetry = TelemetryBuffer(None, log_every)
        return t

    def count_syncs(with_telemetry: bool) -> tuple[int, list[str]]:
        t = fresh(with_telemetry)
        t._run_single(batches[0], 0, None)  # first use: images, allocator
        if t._telemetry is not None:
            t._telemetry.drain()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for b in batches[1:]:
                    t._run_single(b, 0, None)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        if t._telemetry is not None and (t._telemetry.drains, len(t._telemetry._entries)) != (
                1, len(batches) - 1):
            raise RuntimeError("[obs] the buffer drained between the counted steps")
        # Torch's own words for a sync it caught (its first use of the mode
        # also warns that the mode is a prototype: not a sync).
        msgs = [str(w.message) for w in caught
                if "called a synchronizing CUDA operation" in str(w.message)]
        return len(msgs), msgs[:3]

    syncs = {label: count_syncs(label == "telemetry") for label in ("plain", "telemetry")}
    log(f"[obs] synchronizing calls over {len(batches) - 1} steps between two drains "
        f"(torch.cuda.set_sync_debug_mode('warn')): without telemetry {syncs['plain'][0]}, "
        f"with telemetry {syncs['telemetry'][0]} {syncs['telemetry'][1]}")
    if syncs["telemetry"][0] != syncs["plain"][0]:
        raise RuntimeError(f"[obs] telemetry added host syncs: {syncs}")

    # (6) What the plane costs: waited-for steps by the host clock, turns
    # without / with --telemetry --log_every 10 (no drain inside the 8
    # steps), and the device busy share of one step of each.
    def step_ms(with_telemetry: bool) -> float:
        t = fresh(with_telemetry, log_every=10)
        times = []
        for epoch in range(2):
            t.train_loader.set_epoch(epoch)
            for b in t.train_loader:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                t._run_single(b, epoch, None)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
        return statistics.median(times[1:])

    times: dict[str, list[float]] = {"plain": [], "telemetry": []}
    for label in ("plain", "telemetry", "telemetry", "plain"):
        times[label].append(round(step_ms(label == "telemetry"), 3))
    busy, host_ops = {}, {}
    for label in ("plain", "telemetry"):
        t = fresh(label == "telemetry")
        t._run_single(batches[0], 0, None)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            t._run_single(batches[1], 0, None)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t1) * 1e3
        rows = kernel_rows(prof)
        busy[label] = (sum(r[0] for r in rows), wall_ms, sum(r[1] for r in rows))
        host_ops[label] = {e.key: (e.self_cpu_time_total / 1e3, e.count)
                           for e in prof.key_averages()}
    log(f"[obs] step time, host clock around each waited-for step, median of steps 2..8, "
        f"turns plain/telemetry/telemetry/plain: without {times['plain']} ms, with --telemetry "
        f"--log_every 10 {times['telemetry']} ms on {card}")
    for label, (dev_ms, wall_ms, n) in busy.items():
        log(f"[obs] one {label} step: device busy {dev_ms:.3f} ms of {wall_ms:.3f} ms wall "
            f"({dev_ms / wall_ms:.1%} busy), {n} kernels")
    plain_ops = host_ops["plain"]
    grown = sorted(((ms - plain_ops.get(k, (0.0, 0))[0], k, n - plain_ops.get(k, (0.0, 0))[1])
                    for k, (ms, n) in host_ops["telemetry"].items()), reverse=True)[:8]
    log(f"[obs] host ops whose self CPU time grew most in the profiled telemetry step (ms, "
        f"op, calls added): {[(round(d, 3), k[:50], c) for d, k, c in grown]}")

    # Where a telemetry step's extra time goes: each of its reductions
    # alone on the trainer of a step just taken, host clock around the
    # waited-for call (median of 20) beside its device time.
    t = fresh(True)
    t._run_single(batches[0], 0, None)
    params = t._opt_params()
    grads = [p.grad for p in params]
    scores = torch.softmax(torch.randn(4, 1024, cfg.n_expert, device="cuda"), -1)
    mask = torch.ones(4, 1024, device="cuda")
    pieces = {
        "grad_norm (foreach norm of the gradients)": lambda: global_norm(grads),
        "update_norm (from AdamW's state)": lambda: adamw_update_norm(t.optimizer),
        "param_norm": lambda: global_norm(params),
        "gate_stats (one forward)": lambda: layers.gate_stats(scores, mask),
    }
    for name, fn in pieces.items():
        host = []
        for _ in range(20):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t1) * 1e3)
        log(f"[obs] {name}: host clock {statistics.median(host):.3f} ms (waited for), device "
            f"{device_ms(torch, fn, iters=10):.4f} ms, over {len(params)} tensors")

    # (7) The NaN watchdog: one poisoned sample, --telemetry.
    nan_dir = TRAIN_OUT / "obs" / "nan"
    nan_argv = TRAIN_ARGV + ["--epochs", "1", "--telemetry", "--metrics_path",
                             str(nan_dir / "m.jsonl")]
    load = port_main.datasets.load

    def poisoned(data):
        train, test = load(data)
        train[2].coords[0, 0] = float("nan")
        return train, test

    port_main.datasets.load = poisoned
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            port_main.run(nan_argv)
    except FloatingPointError as err:
        message = str(err)
    else:
        raise RuntimeError("[obs] the poisoned run did not raise")
    finally:
        port_main.datasets.load = load
    nan_recs = [r for r in read_jsonl(nan_dir / "m.jsonl") if r.get("event") == "non_finite_loss"]
    log(f"[obs] poisoned run: FloatingPointError({message!r}); records {nan_recs}")
    if ("epoch 0" not in message or len(nan_recs) != 1 or events.validate_record(nan_recs[0])
            or not str(nan_recs[0]["detail"]).endswith(": nan")
            or str(nan_recs[0]["detail"]).startswith("loss")):
        raise RuntimeError("[obs] the NaN watchdog did not record and name a module")

    # (8) Serving with a sink and a tracer: phase 4's traffic.
    serve_dir = TRAIN_OUT / "obs" / "serve"
    serve_argv = OBS_SERVE_ARGV + ["--metrics_path", str(serve_dir / "m.jsonl"),
                                   "--trace_path", str(serve_dir / "t.json")]
    fused_gated_ffn_kernel.launches = 0
    run, serve_lines = run_observed(port_main, serve_argv)
    serve_launches = fused_gated_ffn_kernel.launches
    summary = run.summary
    served = sum(r.ok for r in run.results)
    serve_recs = read_jsonl(serve_dir / "m.jsonl")
    invalid = [(r, p) for r in serve_recs if (p := events.validate_record(r))]
    depth = [r for r in serve_recs if r.get("event") == "queue_depth"]
    summaries = [r for r in serve_recs if r.get("event") == "serve_summary"]
    buckets = summary["pad_waste_by_bucket"].values()
    tokens = [sum(r[k] for r in depth) for k in ("real_tokens", "capacity_tokens")]
    want_tokens = [sum(b[k] for b in buckets) for k in ("real_tokens", "capacity_tokens")]
    chains = span_counts(serve_dir / "t.json")
    full = [t for t, c in chains.items()
            if sorted(n for n, _ in c) == sorted(tracing.SERVE_SPANS) and sum(c.values()) == 7]
    dispatches = summary["dispatches"] + summary["warmed_buckets"]
    log(f"[obs] python -m gnot_tpu_torch.main {' '.join(serve_argv)}: {served}/16 ok, "
        f"{len(depth)} queue_depth records (tokens {tokens}, summary {want_tokens}), "
        f"{len(summaries)} serve_summary, every record valid {not invalid}; {len(full)} of "
        f"{len(chains)} traces hold the whole chain {list(tracing.SERVE_SPANS)}; "
        f"{[line for line in serve_lines if line.startswith('Wrote ')]}")
    log(f"[obs] serve_summary: {json.dumps({k: summaries[0][k] for k in events.EVENTS['serve_summary'].fields}) if summaries else None}")
    log(f"[obs] fused_gated_ffn launches {serve_launches} = 2 x {n_blocks} blocks x {dispatches} "
        f"dispatches ({summary['dispatches']} served + {summary['warmed_buckets']} warm-up)")
    if (served != 16 or invalid or len(summaries) != 1 or len(depth) != summary["dispatches"]
            or tokens != want_tokens or len(full) != 16 or len(chains) != 16
            or serve_launches != 2 * n_blocks * dispatches):
        raise RuntimeError("[obs] the observed serving run is not whole")
    return {"telemetry_train_launches": launches, "telemetry_serve_launches": serve_launches}


class DroppingLoader:
    """A train loader that leaves out one dispatch of one epoch: phase 12's
    reference for a rollback that quarantined that dispatch."""

    def __init__(self, loader, epoch: int, ordinal: int):
        self.loader, self.drop_epoch, self.drop = loader, epoch, ordinal
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        self.loader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        epoch, self._epoch = self._epoch, self._epoch + 1
        for i, batch in enumerate(self.loader):
            if not (epoch == self.drop_epoch and i == self.drop):
                yield batch


def resilience_run(port_main, argv: list[str], tag: str, expect_raise: bool = False):
    """``port_main.run`` of ``argv`` with its console captured and the FFN
    kernel's count set to 0 just before it and read just after: (trainer or
    None, lines, launches, the sink's records)."""
    from gnot_tpu_torch.ops.fused_ffn import fused_gated_ffn_kernel

    metrics = Path(argv[argv.index("--metrics_path") + 1])
    metrics.unlink(missing_ok=True)
    fused_gated_ffn_kernel.launches = 0
    t0 = time.perf_counter()
    try:
        trainer, lines = run_observed(port_main, argv)
    except FloatingPointError as err:
        if not expect_raise:
            raise
        trainer, lines = None, [f"FloatingPointError: {err}"]
    launches = fused_gated_ffn_kernel.launches
    log(f"[resil] ({tag}) python -m gnot_tpu_torch.main {' '.join(argv)}: "
        f"{time.perf_counter() - t0:.2f} s, fused_gated_ffn launches {launches}")
    for line in lines:
        if line and not line.startswith("USDT"):
            log(f"[resil]   {line}")
    recs = read_jsonl(metrics)
    return trainer, lines, launches, recs


def events_of(recs: list[dict]) -> list[dict]:
    return [r for r in recs if "event" in r]


def resilience_phase(torch, np, card: str, phase6_trainer) -> dict:
    """Phase 12: recovery, fault injection, graceful preemption and the
    checkpointer's fallback chain, each through the port's command-line
    run at phase 6's configuration with the FFN kernel in every step
    (replayed and restored steps included); then their costs. Returns the
    FFN kernel's launches over each run."""
    import shutil
    import warnings

    from gnot_tpu_torch import main as port_main
    from gnot_tpu_torch.obs import events
    from gnot_tpu_torch.resilience.supervisor import RecoverySupervisor, _copy_state
    from gnot_tpu_torch.train.checkpoint import Checkpointer, host_copy
    from gnot_tpu_torch.train.trainer import Trainer

    root = TRAIN_OUT / "resil"
    shutil.rmtree(root, ignore_errors=True)
    n_blocks = phase6_trainer.model_cfg.n_attn_layers
    per_forward = 2 * n_blocks
    evals = len(phase6_trainer.test_loader)
    base_losses = [r.step_losses for r in phase6_trainer.history]

    def argv_for(name: str, *flags: str) -> list[str]:
        return TRAIN_ARGV + list(flags) + ["--metrics_path", str(root / name / "m.jsonl")]

    def invalid(recs):
        return [(r, p) for r in recs if (p := events.validate_record(r))]

    out: dict[str, int] = {}

    # (a) A NaN step rolled back: snapshot every 2 steps, nan_grad at step 3.
    flags = ["--recovery", "--snapshot_every", "2", "--inject_fault", "nan_grad@3", "--telemetry"]
    trainer, _, launches, recs = resilience_run(port_main, argv_for("a", *flags), "a")
    evs = events_of(recs)
    kinds = [e["event"] for e in evs]
    # Dispatched: epoch 0's 4 steps (the poisoned step 3 runs the kernel too,
    # and step 4 runs on its NaN weights before the window's check), the
    # replay of dispatch 3 after the rollback to step 2, epoch 1's 4 steps.
    dispatched = 4 + 1 + 4
    want_launches = per_forward * (dispatched + 2 * evals)
    cfg_args = port_main.build_parser().parse_args(argv_for("a-ref", "--telemetry"))
    cfg = port_main.train_config(cfg_args)
    train_s, test_s = port_main.datasets.load(cfg.data)
    ref = Trainer(cfg, port_main.model_config(cfg_args, train_s), train_s, test_s,
                  device=phase6_trainer.device)
    ref.train_loader = DroppingLoader(ref.train_loader, epoch=0, ordinal=2)
    with contextlib.redirect_stdout(io.StringIO()):
        ref.fit()
    got_l = [r.step_losses for r in trainer.history]
    want_l = [r.step_losses for r in ref.history]
    bitwise = all(np.array_equal(a, b) for a, b in zip(got_l, want_l, strict=True))
    log(f"[resil] (a) events {[(e['event'], e.get('step'), e.get('to_step'), e.get('ordinal')) for e in evs]}; "
        f"launches {launches} = {per_forward} x ({dispatched} dispatched steps + {2 * evals} eval "
        f"forwards); step losses {[l.tolist() for l in got_l]}; the run whose epoch-0 loader drops "
        f"dispatch 2: {[l.tolist() for l in want_l]}; bitwise {bitwise}")
    if (kinds != ["rollback", "batch_quarantined"] or evs[0]["to_step"] != 2
            or evs[1]["ordinal"] != 2 or invalid(recs) or not bitwise
            or launches != want_launches or [len(l) for l in got_l] != [3, 4]):
        raise RuntimeError("[resil] (a) the rollback is not whole")
    out["recovery_train_launches"] = launches

    # (b) No rollback budget: the ladder restores 'latest' and goes on.
    ck_b = root / "b" / "ck"
    flags = ["--recovery", "--max_rollbacks", "0", "--checkpoint_every", "1", "--inject_fault",
             "nan_grad@6", "--checkpoint_dir", str(ck_b)]
    trainer, _, launches, recs = resilience_run(port_main, argv_for("b", *flags), "b")
    evs = events_of(recs)
    restore = [e for e in evs if e["event"] == "recovery_restore"]
    want_launches = per_forward * (12 + 2 * evals)
    log(f"[resil] (b) events {[(e['event'], e.get('dir') or e.get('restored_from')) for e in evs]}; "
        f"launches {launches} = {per_forward} x (12 steps: epoch 1 twice + {2 * evals} eval "
        f"forwards); best {trainer.best_metric}")
    if (len(restore) != 1 or restore[0]["restored_from"] != "latest.1.pt"
            or restore[0]["restored_epoch"] != 1 or not math.isfinite(trainer.best_metric)
            or invalid(recs) or launches != want_launches):
        raise RuntimeError("[resil] (b) the escalation to a restore is not whole")
    out["recovery_restore_train_launches"] = launches

    # (c) stop_epoch@1, then --resume: epoch 1 bitwise the uninterrupted run
    # (phase 6's, the same flags without checkpoints). The first run is
    # traced: its checkpoint_save spans are the async save's host time.
    ck_c = root / "c" / "ck"
    flags = ["--checkpoint_dir", str(ck_c), "--checkpoint_every", "1"]
    first, _, l1, recs1 = resilience_run(
        port_main, argv_for("c", *flags, "--inject_fault", "stop_epoch@1", "--trace_path",
                            str(root / "c" / "t.json")), "c stop")
    resumed, _, l2, recs2 = resilience_run(port_main, argv_for("c2", *flags, "--resume"),
                                           "c resume")
    stop_bitwise = np.array_equal(first.history[0].step_losses, base_losses[0])
    res_bitwise = np.array_equal(resumed.history[0].step_losses, base_losses[1])
    log(f"[resil] (c) stop after epoch {[r.epoch for r in first.history]}, resumed epochs "
        f"{[r.epoch for r in resumed.history]} from step {first.host_step}; "
        f"epoch 0 bitwise phase 6's {stop_bitwise}, resumed epoch 1 bitwise phase 6's {res_bitwise}; "
        f"launches {l1} + {l2}; restore {[e.get('dir') for e in events_of(recs2)]}")
    if (not (stop_bitwise and res_bitwise) or [r.epoch for r in resumed.history] != [1]
            or l1 != per_forward * (4 + evals) or l2 != per_forward * (4 + evals)
            or resumed.best_metric != phase6_trainer.best_metric):
        raise RuntimeError("[resil] (c) stop and resume are not the uninterrupted run")
    out["stop_resume_train_launches"] = l1 + l2
    save_spans = [e for e in json.load(open(root / "c" / "t.json"))["traceEvents"]
                  if e["name"] == "checkpoint_save"]

    # (d1) SIGTERM before step 3: latest saved at epoch 0, resumable; resume.
    ck_d = root / "d1" / "ck"
    flags = ["--checkpoint_dir", str(ck_d)]
    _, _, l1, recs = resilience_run(port_main, argv_for("d1", *flags, "--inject_fault",
                                                        "sigterm@3"), "d1 sigterm")
    pre = [e for e in events_of(recs) if e["event"] == "preempt_save"]
    resumed, _, l2, recs2 = resilience_run(port_main, argv_for("d1b", *flags, "--resume"),
                                           "d1 resume")
    log(f"[resil] (d1) {pre}; resumed at epoch {resumed.history[0].epoch} from step 3, best "
        f"{resumed.best_metric}; launches {l1} + {l2}")
    if (len(pre) != 1 or not pre[0]["resumable"] or (pre[0]["epoch"], pre[0]["step"]) != (0, 3)
            or not math.isfinite(resumed.best_metric) or l1 != per_forward * 3
            or l2 != per_forward * (8 + 2 * evals)):
        raise RuntimeError("[resil] (d1) the preemption save or its resume is not whole")

    # (d2) corrupt_ckpt@1 (with a stop after epoch 0): resume falls back.
    ck_d2 = root / "d2" / "ck"
    flags = ["--checkpoint_dir", str(ck_d2), "--checkpoint_every", "1"]
    _, _, l3, _ = resilience_run(port_main, argv_for(
        "d2", *flags, "--inject_fault", "corrupt_ckpt@1,stop_epoch@1"), "d2 corrupt")
    resumed, _, l4, recs = resilience_run(port_main, argv_for("d2b", *flags, "--resume"),
                                          "d2 resume")
    fb = [e for e in events_of(recs) if e["event"] == "restore_fallback"]
    log(f"[resil] (d2) {fb}; best {resumed.best_metric}; launches {l3} + {l4}")
    if (len(fb) != 1 or fb[0]["name"] != "best"
            or [s.split(" ")[0] for s in fb[0]["requested_skipped"]] != ["latest.1.pt"]
            or not math.isfinite(resumed.best_metric) or invalid(recs)):
        raise RuntimeError("[resil] (d2) the fallback past the corrupt file is not whole")
    out["preempt_resume_train_launches"] = l1 + l2 + l3 + l4

    # (e) Two transient I/O errors: retried, and every save commits.
    ck_e = root / "e" / "ck"
    trainer, _, launches, recs = resilience_run(port_main, argv_for(
        "e", "--checkpoint_dir", str(ck_e), "--checkpoint_every", "1", "--inject_fault",
        "ckpt_io@2"), "e")
    retries = [e for e in events_of(recs) if e["event"] == "io_retry"]
    ck = Checkpointer(str(ck_e))
    latest, best = ck.restore_latest(), ck.restore_best()
    files = sorted(re.sub(r"^best\.\d+\.pt$", "best.N.pt", p.name) for p in ck_e.iterdir())
    log(f"[resil] (e) io_retry {[(e['op'], e['attempt']) for e in retries]}; files {files}; "
        f"latest epoch {latest and latest[1]}, best epoch {best and best[1]}")
    if (len(retries) != 2 or latest is None or latest[1] != 2 or best is None
            or files != ["best.N.pt", "best.json", "latest.2.pt", "latest.json"]):
        raise RuntimeError("[resil] (e) a save did not commit")
    out["ckpt_io_train_launches"] = launches

    # (f) What it costs.
    t = fresh_trainer(Trainer, phase6_trainer, "pallas")
    batches = list(t.train_loader)
    t._run_single(batches[0], 0, None)
    torch.cuda.synchronize()
    state = t.state_dict()
    n_tensors = sum(1 for _ in _tensor_leaves(state))
    n_bytes = sum(x.numel() * x.element_size() for x in _tensor_leaves(state) if x.is_cuda)
    snap_dev = device_ms(torch, lambda: _copy_state(t.state_dict()), iters=10)
    snap_events = cuda_ms(torch, lambda: _copy_state(t.state_dict()), iters=10, warmup=2)
    bound = 2 * n_bytes / PEAK_BYTES_PER_S * 1e3
    host = []
    for _ in range(10):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _copy_state(t.state_dict())
        host.append((time.perf_counter() - t1) * 1e3)
        torch.cuda.synchronize()
    log(f"[resil] (f) one snapshot of the train state ({n_tensors} tensors, {n_bytes / 1e6:.1f} MB "
        f"on the card): device time {snap_dev:.4f} ms (CUDA events, host enqueue included, "
        f"{snap_events:.4f} ms); host {statistics.median(host):.3f} ms; bound {bound:.4f} ms "
        f"(bytes: read and write once at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s) on {card}")
    d2h_dev = device_ms(torch, lambda: host_copy(t.state_dict()), iters=5)
    log(f"[resil] (f) the async save's copy to page-locked host memory: device time "
        f"{d2h_dev:.4f} ms ({n_bytes / 1e6:.1f} MB) on {card}")

    def count_syncs(mode: str) -> int:
        f = fresh_trainer(Trainer, phase6_trainer, "pallas")
        if mode == "debug_checks":
            f.config = dataclasses.replace(
                f.config, train=dataclasses.replace(f.config.train, debug_checks=True))
        sup = RecoverySupervisor(snapshot_every=2) if mode == "recovery" else None
        losses = []

        def step(i):
            start = f.host_step
            losses.append(f._run_single(batches[i], 0, None))
            if sup is not None:
                sup.after_dispatch(f.state_dict, ordinal=i, start_step=start,
                                   end_step=f.host_step, losses=losses, points=0, epoch=0)

        if sup is not None:
            sup.begin_epoch(f.state_dict, host_step=0)
        step(0)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                step(1)
                step(2)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        if sup is not None and sup.snapshots != 2:
            raise RuntimeError(f"[resil] expected one snapshot in the window, took {sup.snapshots - 1}")
        return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)

    syncs = {m: count_syncs(m) for m in ("plain", "recovery", "debug_checks")}
    log(f"[resil] (f) synchronizing calls over one snapshot window (2 steps, snapshot_every 2): "
        f"plain {syncs['plain']}, --recovery {syncs['recovery']}, --debug_checks "
        f"{syncs['debug_checks']} on {card}")
    if syncs != {"plain": 0, "recovery": 1, "debug_checks": 2}:
        raise RuntimeError(f"[resil] unexpected host syncs {syncs}")

    def step_ms(mode: str) -> float:
        f = fresh_trainer(Trainer, phase6_trainer, "pallas")
        if mode == "debug_checks":
            f.config = dataclasses.replace(
                f.config, train=dataclasses.replace(f.config.train, debug_checks=True))
        sup = RecoverySupervisor(snapshot_every=2) if mode == "recovery" else None
        times = []
        for epoch in range(2):
            f.train_loader.set_epoch(epoch)
            losses = []
            if sup is not None:
                sup.begin_epoch(f.state_dict, host_step=f.host_step)
            for i, b in enumerate(f.train_loader):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                start = f.host_step
                losses.append(f._run_single(b, epoch, None))
                if sup is not None:
                    sup.after_dispatch(f.state_dict, ordinal=i, start_step=start,
                                       end_step=f.host_step, losses=losses, points=0, epoch=epoch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
        return statistics.median(times[1:])

    turns: dict[str, list[float]] = {"plain": [], "recovery": [], "debug_checks": []}
    for mode in ("plain", "recovery", "debug_checks", "debug_checks", "recovery", "plain"):
        turns[mode].append(round(step_ms(mode), 3))
    log(f"[resil] (f) waited-for step time, host clock, median of steps 2..8, turns "
        f"plain/recovery/debug/debug/recovery/plain: {json.dumps(turns)} ms on {card}")

    # The checkpoint_save span's host time: the checkpointer's async save (the traced
    # run of (c)) and, on the same state, a synchronous torch.save of the
    # live state (the checkpointer's former write).
    spans = [(s["args"].get("which"), round(s["dur"] / 1e3, 3)) for s in save_spans]
    sync_ms, async_ms, wait_ms = [], [], []
    sync_dir = root / "sync"
    sync_dir.mkdir(parents=True, exist_ok=True)
    ck_f = Checkpointer(str(root / "f" / "ck"))
    for turn in ("sync", "async", "async", "sync"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if turn == "sync":
            tmp = sync_dir / ".best.pt.tmp"
            torch.save({"state": t.state_dict(), "epoch": 0, "best_metric": 1.0}, tmp)
            os.replace(tmp, sync_dir / "best.pt")
            sync_ms.append(round((time.perf_counter() - t1) * 1e3, 3))
        else:
            ck_f.save_best(t.state_dict(), 0, 1.0)
            async_ms.append(round((time.perf_counter() - t1) * 1e3, 3))
            t2 = time.perf_counter()
            ck_f.wait()
            wait_ms.append(round((time.perf_counter() - t2) * 1e3, 3))
    log(f"[resil] (f) checkpoint_save spans of (c)'s traced run (which, host ms): {spans}; "
        f"one save of the full state, turns sync/async/async/sync: a synchronous "
        f"torch.save {sync_ms} ms, the checkpointer's save_best {async_ms} ms (then "
        f"wait() {wait_ms} ms for the write and the publish, off the training path) on {card}")
    return out


# -- phase 13: the single server's failure handling, reload and metrics --------


class ListSink:
    """A sink that keeps its records in memory."""

    def __init__(self):
        self.records: list[dict] = []

    def log(self, **record) -> None:
        self.records.append(record)

    def flush(self) -> None:
        pass


class HeldClock:
    """The monotonic clock, or while ``held`` is set, that reading."""

    def __init__(self):
        self.held: float | None = None

    def __call__(self) -> float:
        return self.held if self.held is not None else time.monotonic()


def served_setup(torch, port_main, ck: Path):
    """Phase 4's traffic and model config, the model on the card holding
    ``ck``'s served weights (``main.restore_for_serving``): (model,
    samples)."""
    from gnot_tpu_torch.train.checkpoint import Checkpointer

    args = port_main.build_parser().parse_args(SERVE13_ARGV + ["--checkpoint_dir", str(ck)])
    data, _ = port_main.configs_from_args(args)
    train_s, samples = port_main.datasets.load(data)
    mc = port_main.model_config(args, train_s)
    model = port_main.GNOT(mc, generator=torch.Generator().manual_seed(args.seed)).to(
        port_main.run_device(args))
    with contextlib.redirect_stdout(io.StringIO()):
        port_main.restore_for_serving(
            model, Checkpointer(str(ck), extra_meta=port_main.checkpoint_meta(args, mc)))
    return model, samples


def checkpoint_weights(torch, model, ck: Path, name: str) -> dict:
    """The standard weights of ``ck``'s ``name`` checkpoint."""
    from gnot_tpu_torch.train.checkpoint import Checkpointer
    from gnot_tpu_torch.train.trainer import serving_weights

    ckpt = Checkpointer(str(ck))
    with contextlib.redirect_stdout(io.StringIO()):
        state = (ckpt.restore_best() if name == "best" else ckpt.restore_latest())[0]
    return serving_weights(state, model.state_dict(), model.config.n_attn_layers, "standard",
                           name)


def engine_on(torch, model, weights: dict | None, dtype: str = "float32"):
    """A fresh engine over a copy of ``model`` holding ``weights``."""
    from gnot_tpu_torch.serve.engine import InferenceEngine

    fresh = copy.deepcopy(model)
    if weights is not None:
        fresh.load_state_dict(weights)
    return InferenceEngine(fresh, batch_size=4, dtype=dtype)


def group_outputs(engine, group) -> list:
    """``group``'s outputs from one 4-row dispatch, as the server cuts them."""
    key = engine.bucket_key(group[0])
    return engine.infer(group, pad_nodes=key[0], pad_funcs=key[1], rows=4)


def submit_group(server, group, **kw) -> list:
    """Submit a group, then wait for each of its requests."""
    futures = [server.submit(s, **kw) for s in group]
    return [f.result(timeout=120) for f in futures]


def plain_outputs(torch, layers, model, samples, dtype: str = "float32") -> list:
    """A forward of ``model`` with every FFN through the kernel's plain
    version (phase 4's reference)."""
    from gnot_tpu_torch.ops.fused_ffn import fused_gated_ffn, fused_gated_ffn_reference
    from gnot_tpu_torch.serve.engine import InferenceEngine

    layers.fused_gated_ffn = fused_gated_ffn_reference
    try:
        return InferenceEngine(model, batch_size=4, dtype=dtype).predict(samples)
    finally:
        layers.fused_gated_ffn = fused_gated_ffn


def hold_to_plain(np, tag: str, results, plain) -> float:
    """Each ok result against its plain forward at phase 4's bars; the
    worst abs difference."""
    worst = 0.0
    for r, want in zip(results, plain):
        if not r.ok or r.output.shape != want.shape:
            raise RuntimeError(f"[{tag}] request {r.reason} {r.detail}")
        np.testing.assert_allclose(r.output, want, rtol=MODEL_RTOL, atol=MODEL_ATOL)
        worst = max(worst, float(np.max(np.abs(r.output - want))))
    return worst


def device_busy_ms(torch, fn) -> tuple[float, float, int, int]:
    """One ``fn()`` under ``torch.profiler``: (device ms over its kernels and
    copies, host ms, device records, kernel launch calls on the host)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        host = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    rows = kernel_rows(prof)
    launch_calls = sum(e.count for e in prof.key_averages()
                       if e.key.startswith(("cudaLaunch", "cuLaunch")))
    return sum(r[0] for r in rows), host, sum(r[1] for r in rows), launch_calls


def serving_policies_phase(torch, np, card: str, layers) -> dict:
    """Phase 13: the single server's deadlines, circuit breaker, serve
    fault injection, hot reload, SIGTERM drain and live metrics plane at
    phase 4's configuration, on weights phase 13 trains itself with phase
    6's configuration; then their costs. Returns the FFN kernel's launches
    over each path."""
    import shutil
    import signal
    import warnings

    from gnot_tpu_torch import main as port_main
    from gnot_tpu_torch.obs import events
    from gnot_tpu_torch.obs.metrics import MetricsRegistry
    from gnot_tpu_torch.ops.fused_ffn import fused_gated_ffn_kernel, packed_weights
    from gnot_tpu_torch.resilience.faults import FaultInjector
    from gnot_tpu_torch.serve.engine import InferenceEngine
    from gnot_tpu_torch.serve.server import CheckpointReloader, InferenceServer
    from gnot_tpu_torch.train.checkpoint import Checkpointer

    root = TRAIN_OUT / "serve13"
    shutil.rmtree(root, ignore_errors=True)
    out: dict[str, int] = {}

    def invalid(recs):
        return [(r, p) for r in recs if (p := events.validate_record(r))]

    # The weights: phase 6's training with best and latest saved each epoch,
    # run with the training side of the metrics plane (e).
    ck = root / "ck"
    argv = TRAIN_ARGV + ["--checkpoint_dir", str(ck), "--checkpoint_every", "1", "--telemetry",
                         "--metrics_interval_s", "0.05", "--metrics_path",
                         str(root / "train" / "m.jsonl")]
    fused_gated_ffn_kernel.launches = 0
    trainer, _ = run_observed(port_main, argv)
    launches = fused_gated_ffn_kernel.launches
    per_forward = 2 * trainer.model_cfg.n_attn_layers
    steps = sum(len(r.step_losses) for r in trainer.history)
    evals = len(trainer.test_loader)
    series = read_jsonl(root / "train" / "m.series.jsonl")
    timed = series[-1]["series"]["train_step_time_ms"]
    manifest = json.load(open(root / "train" / "run.json"))
    names = {p.name for p in ck.iterdir()}
    log(f"[serve13] python -m gnot_tpu_torch.main {' '.join(argv)}: {steps} steps, "
        f"fused_gated_ffn launches {launches}; checkpoints {sorted(names)}; "
        f"train_step_time_ms {timed['count']} records (mean "
        f"{timed['sum'] / max(1, timed['count']):.3f} ms), {len(series)} snapshots, run.json "
        f"metrics {manifest.get('metrics')} on {card}")
    if (launches != per_forward * (steps + 2 * evals) or not {"best.json", "latest.json"} <= names
            or timed["count"] != steps - len(trainer.history) or not manifest.get("metrics")):
        raise RuntimeError("[serve13] the training run, its checkpoints or its step-time "
                           "series are not whole")
    out["metrics_train_launches"] = launches

    model, samples = served_setup(torch, port_main, ck)
    groups = [samples[i:i + 4] for i in range(0, 16, 4)]
    plain = plain_outputs(torch, layers, model, samples)

    # (a) Deadlines: slow_request@1 stalls the first group's dispatch past its
    # 150 ms deadline; the three later groups are served. The stall ends 1 ms
    # past the victim's deadline, so its batchmates share that deadline only
    # when they are admitted at the same clock reading: the first group is
    # submitted with the server's clock held (another thread taking the
    # interpreter between two submits would otherwise let a batchmate
    # outlive the stall).
    sink, clock = ListSink(), HeldClock()
    server = InferenceServer(InferenceEngine(model, batch_size=4), max_batch=4,
                             max_wait_ms=10_000, default_deadline_ms=150.0, sink=sink, clock=clock,
                             faults=FaultInjector.from_spec("slow_request@1")).start(warmup=samples)
    fused_gated_ffn_kernel.launches = 0
    clock.held = time.monotonic()
    futures = [server.submit(s) for s in groups[0]]
    clock.held = None
    results = [f.result(timeout=120) for f in futures]
    results += [r for g in groups[1:] for r in submit_group(server, g)]
    summary = server.drain(60)
    launches = fused_gated_ffn_kernel.launches
    kinds = [r["event"] for r in sink.records]
    sheds = [r for r in sink.records if r["event"] == "shed"]
    worst = hold_to_plain(np, "serve13 a", results[4:], plain[4:])
    log(f"[serve13] (a) reasons {[r.reason for r in results]}; shed ordinals "
        f"{[s['ordinal'] for s in sheds]}; queue_depth events {kinds.count('queue_depth')}; "
        f"launches {launches}; served vs plain max_abs_err {worst:.3e}; shed {summary['shed']}")
    if ([r.reason for r in results[:4]] != ["shed_deadline"] * 4
            or [s["ordinal"] for s in sheds] != [1, 2, 3, 4] or kinds.count("queue_depth") != 3
            or launches != per_forward * 3 or invalid(sink.records)):
        raise RuntimeError("[serve13] (a) the deadline shed is not the victim's dispatch alone")
    out["deadline_serve_launches"] = launches

    # (b) The breaker: nan_output@1,2 trip it (threshold 2), the next request
    # is rejected with no dispatch, and after the 0.2 s cooldown a trial
    # closes it.
    sink = ListSink()
    server = InferenceServer(InferenceEngine(model, batch_size=4), max_batch=4, max_wait_ms=1.0,
                             breaker_threshold=2, breaker_cooldown_s=0.2, sink=sink,
                             faults=FaultInjector.from_spec("nan_output@1,nan_output@2")
                             ).start(warmup=samples)
    fused_gated_ffn_kernel.launches = 0
    results = [server.submit(s).result(timeout=60) for s in samples[:3]]
    time.sleep(0.25)
    results.append(server.submit(samples[3]).result(timeout=60))
    summary = server.drain(60)
    launches = fused_gated_ffn_kernel.launches
    order = [r["event"] if r["event"] != "shed" else r["reason"] for r in sink.records
             if r["event"] in ("breaker_open", "breaker_close", "shed")]
    worst = hold_to_plain(np, "serve13 b", results[3:], plain[3:4])
    log(f"[serve13] (b) reasons {[r.reason for r in results]}; events {order}; breaker_trips "
        f"{summary['breaker_trips']}; launches {launches} (the two poisoned dispatches and the "
        f"trial); served vs plain max_abs_err {worst:.3e}")
    if ([r.reason for r in results] != ["error_nan_output"] * 2 + ["rejected_breaker_open", "ok"]
            or order != ["breaker_open", "rejected_breaker_open", "breaker_close"]
            or summary["breaker_trips"] != 1 or launches != per_forward * 3
            or invalid(sink.records)):
        raise RuntimeError("[serve13] (b) the breaker did not trip and recover as JAX's does")
    out["breaker_serve_launches"] = launches

    # (c1) Four reloads on a server started on fresh weights, each followed
    # by one group: the dispatch after a reload repacks the 40 images, and
    # its outputs are bitwise a fresh engine's on the restored weights; the
    # second reload has reload_corrupt and walks on to 'best'.
    ck1 = root / "ck_c1"
    shutil.copytree(ck, ck1)
    latest_w = checkpoint_weights(torch, model, ck, "latest")
    best_w = checkpoint_weights(torch, model, ck, "best")
    same = all(torch.equal(latest_w[k], best_w[k]) for k in latest_w)
    fresh_model = copy.deepcopy(model)
    fresh_model.load_state_dict(port_main.GNOT(model.config, generator=torch.Generator(
        ).manual_seed(0)).state_dict())
    engine = InferenceEngine(fresh_model, batch_size=4)
    sink = ListSink()
    server = InferenceServer(engine, max_batch=4, max_wait_ms=10_000, sink=sink,
                             reload_fn=CheckpointReloader(Checkpointer(str(ck1)), fresh_model),
                             faults=FaultInjector.from_spec("reload_corrupt@2")
                             ).start(warmup=samples)
    refs = {"latest": engine_on(torch, model, latest_w), "best": engine_on(torch, model, best_w)}
    # The fresh engines' outputs first: their launches are not the path's.
    # From the second reload on, latest stays truncated: each walks on to best.
    wants = [group_outputs(refs["best" if k >= 2 else "latest"], g)
             for k, g in enumerate(groups, 1)]
    latest_first = group_outputs(refs["latest"], groups[0])
    fused_gated_ffn_kernel.launches = 0
    reload_host, repacks, bitwise = [], [], []
    before = submit_group(server, groups[0])
    for k, (group, want) in enumerate(zip(groups, wants), 1):
        packs = packed_weights.packs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server.reload()
        reload_host.append(round((time.perf_counter() - t0) * 1e3, 3))
        moved = packed_weights.packs - packs
        res = submit_group(server, group)
        repacks.append((moved, packed_weights.packs - packs))
        bitwise.append(all(r.ok and np.array_equal(r.output, w) for r, w in zip(res, want)))
    summary = server.drain(60)
    launches = fused_gated_ffn_kernel.launches
    rels = [r for r in sink.records if r["event"] == "reload"]
    log(f"[serve13] (c1) reload events {[(r['ok'], r['name'], r['dir'], r['fallback']) for r in rels]}; "
        f"host ms {reload_host}; packs (after the reload, after its dispatch) {repacks}; outputs "
        f"bitwise a fresh engine's on the restored weights {bitwise}; best and latest hold the "
        f"same weights: {same}; launches {launches} on {card}")
    if (len(rels) != 4 or not all(r["ok"] for r in rels) or rels[0]["fallback"]
            or any(r["name"] != "best" or not r["fallback"] for r in rels[1:])
            or repacks != [(0, 40)] * 4 or not all(bitwise) or summary["reloads"] != 4
            or launches != per_forward * 5 or invalid(sink.records)):
        raise RuntimeError("[serve13] (c1) a reload did not swap, repack once and serve the "
                           "restored weights")
    if all(np.array_equal(b.output, w) for b, w in zip(before, latest_first)):
        raise RuntimeError("[serve13] (c1) the fresh weights already serve latest's outputs")
    out["reload_serve_launches"] = launches

    # (c2) + (e) Through main: --serve_reload_every 4 with the metrics plane on.
    def serve_run(tag: str, *flags: str, corrupts: bool = False):
        """``main``'s serve run of phase 4's traffic on the checkpoint (a
        copy of it when the run corrupts it), its counts set to 0 just
        before and read just after."""
        d = root / tag
        d.mkdir(parents=True)
        run_ck = ck
        if corrupts:
            run_ck = d / "ck"
            shutil.copytree(ck, run_ck)
        argv = SERVE13_ARGV + ["--checkpoint_dir", str(run_ck), "--metrics_path",
                               str(d / "m.jsonl"), *flags]
        fused_gated_ffn_kernel.launches = 0
        packs = packed_weights.packs
        t0 = time.perf_counter()
        run, lines = run_observed(port_main, argv)
        launches = fused_gated_ffn_kernel.launches
        recs = read_jsonl(d / "m.jsonl")
        log(f"[serve13] ({tag}) python -m gnot_tpu_torch.main {' '.join(argv)}: "
            f"{time.perf_counter() - t0:.2f} s, fused_gated_ffn launches {launches}, packs "
            f"{packed_weights.packs - packs}")
        for line in lines:
            if line.startswith(("Metrics plane", "WARNING")):
                log(f"[serve13]   {line}")
        return run, recs, launches, packed_weights.packs - packs, d

    flags = ["--serve_reload_every", "4", "--metrics_interval_s", "0.05", "--slo_p99_ms", "1",
             "--slo_fast_window_s", "0.1", "--slo_slow_window_s", "0.2"]
    run, recs, launches, packs, d = serve_run("c2", *flags)
    rels = [r for r in recs if r.get("event") == "reload"]
    alerts = [(r["objective"], r["state"]) for r in recs if r.get("event") == "slo_alert"]
    snaps = [r for r in recs if r.get("event") == "metrics_snapshot"]
    manifest = json.load(open(d / "run.json"))
    dispatches = run.summary["dispatches"] + run.summary["warmed_buckets"]
    plain_ref = {"latest": plain_outputs(torch, layers, refs["latest"].model, samples),
                 "best": plain_outputs(torch, layers, refs["best"].model, samples)}

    def held(results) -> list[bool]:
        """Each output at phase 4's bars of the plain forward of best's or
        latest's weights (which a request met depends on the reloads'
        timing; (c1) holds them bitwise)."""
        return [any(np.allclose(r.output, p[i], rtol=MODEL_RTOL, atol=MODEL_ATOL)
                    for p in plain_ref.values()) for i, r in enumerate(results)]

    match = held(run.results)
    log(f"[serve13] (c2) reasons {sorted(set(r.reason for r in run.results))}; reload events "
        f"{[(r['ok'], r['name'], r['fallback']) for r in rels]}; summary reloads "
        f"{run.summary['reloads']}; packs {packs} (40 per publish a dispatch followed); "
        f"launches {launches} = {per_forward} x {dispatches}; each output at phase 4's bars of "
        f"best's or latest's plain forward: {all(match)} (the same weights: {same})")
    log(f"[serve13] (e) {len(snaps)} metrics_snapshot events; slo_alert edges {alerts}; series "
        f"rows {len(read_jsonl(d / 'm.series.jsonl'))}; .prom {(d / 'm.prom').stat().st_size} B; "
        f"run.json metrics {manifest.get('metrics')}; latency p50 "
        f"{run.summary['latency_p50_ms']:.3f} p99 {run.summary['latency_p99_ms']:.3f} ms on {card}")
    if (len(run.results) != 16 or not all(r.ok for r in run.results) or len(rels) != 4
            or not all(r["ok"] and not r["fallback"] for r in rels) or packs % 40
            or not 40 <= packs <= 200 or launches != per_forward * dispatches or not all(match)
            or invalid(recs)):
        raise RuntimeError("[serve13] (c2) serving with reloads is not whole")
    if (not snaps or ("latency_p99", "fire") not in alerts
            or not manifest.get("metrics", {}).get("summary_agrees")
            or not (d / "m.prom").stat().st_size):
        raise RuntimeError("[serve13] (e) the metrics plane is not whole")
    out["reload_main_serve_launches"] = launches

    # (c3) reload_corrupt@2 through main: that reload walks on to best.
    run, recs, launches, packs, _ = serve_run("c3", "--serve_reload_every", "4",
                                              "--serve_inject_fault", "reload_corrupt@2",
                                              corrupts=True)
    rels = [r for r in recs if r.get("event") == "reload"]
    match = held(run.results)
    log(f"[serve13] (c3) reasons {sorted(set(r.reason for r in run.results))}; reload events "
        f"{[(r['ok'], r['name'], r['dir'], r['fallback']) for r in rels]}; outputs at phase "
        f"4's bars of best's or latest's plain forward: {all(match)}")
    if (not all(r.ok for r in run.results) or len(run.results) != 16 or len(rels) != 4
            or not rels[1]["fallback"] or rels[1]["name"] != "best" or not all(match)):
        raise RuntimeError("[serve13] (c3) the corrupt reload did not fall back to best")
    out["reload_corrupt_serve_launches"] = launches

    # (c4) bf16: one reload through main, then a bf16 server's reload held to
    # phase 4b's bars.
    run, recs, launches, packs, _ = serve_run("c4", "--serve_reload_every", "16",
                                              "--serve_dtype", "bfloat16")
    rels = [r for r in recs if r.get("event") == "reload"]
    bf16_engine = InferenceEngine(fresh_model, batch_size=4, dtype="bfloat16")
    server = InferenceServer(bf16_engine, max_batch=4, max_wait_ms=10_000,
                             reload_fn=CheckpointReloader(Checkpointer(str(ck)), fresh_model)
                             ).start(warmup=samples)
    server.reload()
    dtypes = {str(v.dtype) for v in bf16_engine.model.state_dict().values() if v.is_floating_point()}
    res = [r for g in groups for r in submit_group(server, g)]
    server.drain(60)
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))  # noqa: E731
    restored_model = refs["latest"].model
    plain_bf16 = plain_outputs(torch, layers, restored_model, samples, "bfloat16")
    plain_rel = rel(np.concatenate([r.output for r in res]), np.concatenate(plain_bf16))
    f32_ref = refs["latest"].predict(samples)
    f32_rel = max(rel(r.output, w) for r, w in zip(res, f32_ref))
    log(f"[serve13] (c4) --serve_dtype bfloat16 --serve_reload_every 16: reasons "
        f"{sorted(set(r.reason for r in run.results))}, reload events "
        f"{[(r['ok'], r['name']) for r in rels]}, launches {launches}; a bf16 server's reload "
        f"publishes {sorted(dtypes)}; its outputs vs the plain bf16 forward of the restored "
        f"weights: relative norm {plain_rel:.3e} (bar {BF16_PLAIN_REL}); vs the f32 engine: "
        f"worst request {f32_rel:.3e} (bar {BF16_F32_REL})")
    if (not all(r.ok for r in run.results) or len(rels) != 1 or not rels[0]["ok"]
            or dtypes != {"torch.bfloat16"} or not all(r.ok for r in res)
            or plain_rel > BF16_PLAIN_REL or f32_rel >= BF16_F32_REL):
        raise RuntimeError("[serve13] (c4) the bf16 reload is off its bars")
    out["reload_bf16_serve_launches"] = launches

    # (d) SIGTERM while serving through main: the sixth submit sends it.
    class SignalledServer(InferenceServer):
        def submit(self, sample, **kw):
            fut = super().submit(sample, **kw)
            with self._lock:
                n = self._submitted
            if n == 6:
                os.kill(os.getpid(), signal.SIGTERM)
            return fut

    port_main.InferenceServer = SignalledServer
    try:
        run, recs, launches, _, _ = serve_run("d")
    finally:
        port_main.InferenceServer = InferenceServer
    summaries = [r for r in recs if r.get("event") == "serve_summary"]
    log(f"[serve13] (d) SIGTERM at the sixth submit: {len(run.results)} submitted, reasons "
        f"{[r.reason for r in run.results]}; serve_summary {[(s['requests'], s['completed']) for s in summaries]}; "
        f"launches {launches}")
    if (len(run.results) != 6 or not all(r.ok for r in run.results) or len(summaries) != 1
            or summaries[0]["completed"] != 6):
        raise RuntimeError("[serve13] (d) SIGTERM did not stop the storm and drain the server")
    hold_to_plain(np, "serve13 d", run.results, plain[:6])
    out["sigterm_serve_launches"] = launches

    # (f) Costs. Kernels and synchronizing calls of one dispatch with the
    # deadline, the breaker and the registry on, and with them off.
    def one_dispatch_counts(on: bool):
        kw = dict(default_deadline_ms=60_000.0, metrics=MetricsRegistry()) if on else {}
        server = InferenceServer(InferenceEngine(model, batch_size=4), max_batch=4,
                                 max_wait_ms=10_000, **kw).start(warmup=samples)
        submit_group(server, groups[0])
        busy, host, records, launch_calls = device_busy_ms(
            torch, lambda: submit_group(server, groups[1]))
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                submit_group(server, groups[2])
            finally:
                torch.cuda.set_sync_debug_mode("default")
        server.drain(60)
        syncs = sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)
        return launch_calls, syncs, records, round(busy, 3), round(host, 3)

    turns = [(label, one_dispatch_counts(label == "on")) for label in ("off", "on", "on", "off")]
    log(f"[serve13] (f) one dispatch (4 requests), policies off / on (deadline, breaker, "
        f"registry), turns of (kernel launch calls, synchronizing calls, device records, device "
        f"busy ms, host ms): {turns} on {card}")
    if len({t[1][:2] for t in turns}) != 1:
        raise RuntimeError(f"[serve13] (f) the policies changed a dispatch's launches or syncs: "
                           f"{turns}")

    # A reload's device and host time, and the repack on the dispatch after it.
    engine = InferenceEngine(copy.deepcopy(model), batch_size=4)
    server = InferenceServer(engine, max_batch=4, max_wait_ms=10_000,
                             reload_fn=CheckpointReloader(Checkpointer(str(ck)), engine.model)
                             ).start(warmup=samples)
    submit_group(server, groups[0])
    n_bytes = sum(v.numel() * v.element_size() for v in engine.model.state_dict().values())
    costs = []
    for _ in range(3):
        rl_dev, rl_host, rl_n, _ = device_busy_ms(torch, server.reload)
        first_dev, first_host, _, _ = device_busy_ms(torch, lambda: submit_group(server, groups[1]))
        next_dev, next_host, _, _ = device_busy_ms(torch, lambda: submit_group(server, groups[1]))
        costs.append((round(rl_dev, 3), round(rl_host, 3), rl_n, round(first_dev - next_dev, 3),
                      round(first_host - next_host, 3)))
    server.drain(60)
    log(f"[serve13] (f) a reload ({n_bytes / 1e6:.1f} MB of weights to the card), turns of "
        f"(device ms, host ms, device records, repack device ms = first dispatch after it minus "
        f"the next, the same for host ms): {costs}; bound of the copy to the card "
        f"{n_bytes / 25e9 * 1e3:.3f} ms at 25 GB/s (PCIe) on {card}")

    # A storm's dispatch times with and without the publisher thread, in turns.
    turns = {"without": [], "with": []}
    for label in ("without", "with", "with", "without"):
        extra = ["--metrics_interval_s", "0.05"] if label == "with" else []
        run, _, _, _, _ = serve_run(f"f-{label}-{len(turns[label])}", "--n_test", "64", *extra)
        s = run.summary
        turns[label].append((round(s["dispatch_ms_p50"], 3), round(s["dispatch_ms_max"], 3),
                             round(s["latency_p50_ms"], 3), round(s["latency_p99_ms"], 3)))
    log(f"[serve13] (f) 64 requests, 16 dispatches: (dispatch p50, dispatch max = p99 of 16, "
        f"latency p50, latency p99) host ms without / with the publisher thread at 0.05 s, "
        f"turns: {json.dumps(turns)} on {card}")
    return out


# -- phase 14: rollout sessions and tenants on the single server ---------------


def rollout_tenants_phase(torch, np, card: str, layers) -> dict:
    """Phase 14: rollout sessions and tenants at phase 4's configuration
    (the reference default, random weights from ``--seed 0``): (a) main's
    16 sessions x 8 steps through the kernel, held to ``offline_rollout``;
    (b) the same through the plain FFN path; (c) in bf16; (d) the three
    rollout faults; (e) SIGTERM mid-rollout and the resume from the
    session store; (f) a tenant storm; (g) their costs. Returns the FFN
    kernel's launches over each path."""
    import shutil
    import signal
    import warnings

    from gnot_tpu_torch import main as port_main
    from gnot_tpu_torch.obs import events
    from gnot_tpu_torch.obs import metrics as metrics_lib
    from gnot_tpu_torch.ops.fused_ffn import fused_gated_ffn_kernel
    from gnot_tpu_torch.resilience.faults import FaultInjector
    from gnot_tpu_torch.resilience.preemption import PreemptionHandler
    from gnot_tpu_torch.serve.engine import InferenceEngine
    from gnot_tpu_torch.serve.policies import TenantPolicy
    from gnot_tpu_torch.serve.rollout import (
        SessionStore,
        advance_sample,
        offline_rollout,
        parity_check,
    )
    from gnot_tpu_torch.serve.server import InferenceServer

    root = TRAIN_OUT / "rollout14"
    shutil.rmtree(root, ignore_errors=True)
    out: dict[str, int] = {}
    k_steps = ROLLOUT_K

    def invalid(recs):
        return [(r, p) for r in recs if (p := events.validate_record(r))]

    def main_run(tag: str, *flags: str):
        """``main``'s rollout serve of phase 4's traffic, its count set to 0
        just before and read just after."""
        d = root / tag
        d.mkdir(parents=True)
        argv = ROLLOUT_ARGV + ["--serve_rollout_steps", str(k_steps), "--session_snapshot_every",
                               "2", "--metrics_path", str(d / "m.jsonl"), *flags]
        fused_gated_ffn_kernel.launches = 0
        t0 = time.perf_counter()
        run, lines = run_observed(port_main, argv)
        launches = fused_gated_ffn_kernel.launches
        log(f"[rollout] ({tag}) python -m gnot_tpu_torch.main {' '.join(argv)}: "
            f"{time.perf_counter() - t0:.2f} s, fused_gated_ffn launches {launches}")
        for line in lines:
            if line.startswith(("Serve:", "Metrics plane", "WARNING")):
                log(f"[rollout]   {line}")
        return run, read_jsonl(d / "m.jsonl"), launches, d

    def whole(tag: str, run, launches: int, per_forward: int) -> int:
        s = run.summary
        dispatches = s["dispatches"] + s["warmed_buckets"]
        sess = s["sessions"]
        if (len(run.results) != 16 or not all(r.ok and len(r.outputs) == k_steps
                                              for r in run.results)
                or (sess["started"], sess["completed"], sess["steps"]) != (16, 16, 16 * k_steps)
                or launches != per_forward * dispatches):
            raise RuntimeError(f"[rollout] ({tag}) the storm is not whole: "
                               f"{[(r.reason, r.detail) for r in run.results if not r.ok]}, "
                               f"sessions {sess}, launches {launches} for {dispatches} dispatches")
        return dispatches

    # (a) 16 sessions x 8 steps through main, the metrics plane on.
    run_a, recs, launches, d = main_run("a", "--metrics_interval_s", "0.05")
    model = run_a.model
    samples = run_a.samples
    per_forward = 2 * model.config.n_attn_layers
    dispatches = whole("a", run_a, launches, per_forward)
    final = read_jsonl(d / "m.series.jsonl")[-1]["series"]
    steps_total = final["rollout_steps_total"]["value"]
    kinds = [r.get("event") for r in recs]
    engine = InferenceEngine(model, batch_size=4)
    offline = [offline_rollout(engine, s, k_steps, rows=4) for s in samples]
    worst = max(parity_check(r.outputs, o) for r, o in zip(run_a.results, offline))
    bitwise = all(np.array_equal(a, b) for r, o in zip(run_a.results, offline)
                  for a, b in zip(r.outputs, o))
    sess = run_a.summary["sessions"]
    log(f"[rollout] (a) sessions {sess['completed']}/{sess['started']}, steps {sess['steps']}, "
        f"rollout_steps_total {steps_total}, {kinds.count('rollout_step')} rollout_step and "
        f"{kinds.count('session_snapshot')} session_snapshot events; launches {launches} = "
        f"{per_forward} x {dispatches} dispatches ({run_a.summary['dispatches']} served + "
        f"{run_a.summary['warmed_buckets']} warm-up); served vs offline_rollout (rows 4) on the "
        f"same engine: worst per-step max abs {worst:.3e} (bar {ROLLOUT_PARITY}), bitwise "
        f"{bitwise}; step latency p50 {sess['step_latency_p50_ms']:.3f} p99 "
        f"{sess['step_latency_p99_ms']:.3f} ms on {card}")
    if (steps_total != 16 * k_steps or kinds.count("rollout_step") != 16 * k_steps
            or worst > ROLLOUT_PARITY or invalid(recs)):
        raise RuntimeError("[rollout] (a) the served trajectories are off offline_rollout")
    out["rollout_serve_launches"] = launches

    # (b) The same sessions through the plain FFN path (ffn_impl=xla).
    run_b, _, launches_b, _ = main_run("b", "--ffn_impl", "xla")
    whole("b", run_b, launches_b, 0)
    per_step = [max(float(np.max(np.abs(a.outputs[i] - b.outputs[i])))
                    for a, b in zip(run_a.results, run_b.results)) for i in range(k_steps)]
    for a, b in zip(run_a.results, run_b.results):
        np.testing.assert_allclose(a.outputs[0], b.outputs[0], rtol=MODEL_RTOL, atol=MODEL_ATOL)
    log(f"[rollout] (b) ffn_impl=xla: launches {launches_b}; kernel vs plain path, worst max abs "
        f"per step 1..{k_steps}: {[f'{w:.2e}' for w in per_step]} (step 1 held to rtol "
        f"{MODEL_RTOL} atol {MODEL_ATOL}; later steps carry the difference through the "
        f"carry: growth x{per_step[-1] / max(per_step[0], 1e-30):.1f} over {k_steps} steps)")
    if launches_b:
        raise RuntimeError("[rollout] (b) the plain path launched the kernel")

    # (c) bf16.
    run_c, recs_c, launches_c, _ = main_run("c", "--serve_dtype", "bfloat16")
    whole("c", run_c, launches_c, per_forward)
    engine_c = InferenceEngine(run_c.model, batch_size=4, dtype="bfloat16")
    offline_c = [offline_rollout(engine_c, s, k_steps, rows=4) for s in samples]
    worst_c = max(parity_check(r.outputs, o) for r, o in zip(run_c.results, offline_c))
    bitwise_c = all(np.array_equal(a, b) for r, o in zip(run_c.results, offline_c)
                    for a, b in zip(r.outputs, o))
    log(f"[rollout] (c) --serve_dtype bfloat16: launches {launches_c}; served vs the bf16 "
        f"offline_rollout of the same engine: worst {worst_c:.3e} (bar {ROLLOUT_PARITY}), "
        f"bitwise {bitwise_c}")
    if worst_c > ROLLOUT_PARITY or invalid(recs_c):
        raise RuntimeError("[rollout] (c) bf16 trajectories are off their offline_rollout")
    out["rollout_bf16_serve_launches"] = launches_c

    # (d) The rollout faults, each on a standalone server: four 4-step
    # sessions submitted before the worker starts run in lockstep, one
    # dispatch a step.
    def faulted(spec: str):
        sink, reg = ListSink(), metrics_lib.MetricsRegistry()
        srv = InferenceServer(InferenceEngine(model, batch_size=4), max_batch=4, max_wait_ms=1.0,
                              sink=sink, metrics=reg, faults=FaultInjector.from_spec(spec))
        futs = [srv.submit_rollout(s, 4) for s in samples[:4]]
        fused_gated_ffn_kernel.launches = 0
        srv.start(warmup=samples[:1])
        results = [f.result(timeout=60) for f in futs]
        if spec.startswith("replica_kill"):
            srv._worker.join(5)
        time.sleep(0.2)
        # The warm-up dispatch's launches left out.
        launches = fused_gated_ffn_kernel.launches - per_forward * srv.warmed
        alive = srv._worker.is_alive()
        summary = srv.drain(60)
        after = fused_gated_ffn_kernel.launches - launches - per_forward * srv.warmed
        lost = reg.counter("rollout_sessions_lost_total").value
        log(f"[rollout] (d) {spec}: reasons {[(r.reason, r.steps_completed) for r in results]}; "
            f"dispatches {summary['dispatches']}, launches {launches} (+{after} after), "
            f"rollout_sessions_lost_total {lost}, shed {summary['shed']}, worker alive before "
            f"the drain {alive}")
        if invalid(sink.records) or launches != per_forward * summary["dispatches"] or after:
            raise RuntimeError(f"[rollout] (d) {spec}: launches or records are off")
        return results, summary, lost, launches, srv, sink

    res, summary, lost, launches, _, _ = faulted("rollout_nan@3")
    if ([(r.reason, r.steps_completed) for r in res] != [("error_nan_output", 0)] * 4
            or lost != 4 or launches != per_forward):
        raise RuntimeError("[rollout] (d) rollout_nan did not poison its whole dispatch")
    out["rollout_nan_serve_launches"] = launches
    res, summary, lost, launches, _, sink = faulted("stale_session@5")
    depths = [r["n"] for r in sink.records if r["event"] == "queue_depth"]
    if ([(r.reason, r.steps_completed) for r in res]
            != [("error_stale_session", 1)] + [("ok", 4)] * 3 or lost != 1
            or depths != [4, 3, 3, 3]):
        raise RuntimeError(f"[rollout] (d) stale_session: dispatch sizes {depths}")
    out["stale_session_serve_launches"] = launches
    res, summary, lost, launches, srv, _ = faulted("replica_kill@9")
    if ([(r.reason, r.steps_completed) for r in res] != [("error_replica_dead", 2)] * 4
            or lost != 4 or launches != 2 * per_forward or srv._worker.is_alive()):
        raise RuntimeError("[rollout] (d) replica_kill did not fail everything and stop")
    out["replica_kill_serve_launches"] = launches

    # (e) SIGTERM mid-rollout under a session store, then the resume on a
    # fresh engine of the same weights.
    store = SessionStore(str(root / "sessions"))
    names = [f"run-{i}" for i in range(4)]
    stored_at_resolve: list[bool] = []
    sink = ListSink()
    with PreemptionHandler() as preempt:
        srv = InferenceServer(InferenceEngine(model, batch_size=4), max_batch=4, max_wait_ms=1.0,
                              sink=sink, preempt=preempt, session_store=store)

        def on_step(sid, k, output):
            if sid == names[0] and k == 3:
                os.kill(os.getpid(), signal.SIGTERM)
                deadline = time.monotonic() + 10
                while not preempt.triggered and time.monotonic() < deadline:
                    time.sleep(0.001)

        futs = [srv.submit_rollout(s, k_steps, name=n, on_step=on_step)
                for s, n in zip(samples[:4], names)]
        for n, f in zip(names, futs):
            f.add_done_callback(lambda _, n=n: stored_at_resolve.append(store.load(n) is not None))
        fused_gated_ffn_kernel.launches = 0
        srv.start(warmup=samples[:1])
        first = [f.result(timeout=120) for f in futs]
        summary = srv.drain(60)
        launches = fused_gated_ffn_kernel.launches - per_forward * srv.warmed
    persisted = [r for r in sink.records if r["event"] == "session_snapshot" and r.get("persisted")]
    fresh_model = port_main.GNOT(model.config, generator=torch.Generator().manual_seed(0)).to(
        next(model.parameters()).device)
    same = all(torch.equal(a, b) for a, b in zip(fresh_model.state_dict().values(),
                                                 model.state_dict().values()))
    srv2 = InferenceServer(InferenceEngine(fresh_model, batch_size=4), max_batch=4,
                           max_wait_ms=1.0, session_store=store)
    futs = [srv2.resume_rollout(n) for n in names]
    fused_gated_ffn_kernel.launches = 0
    srv2.start()
    second = [f.result(timeout=120) for f in futs]
    summary2 = srv2.drain(60)
    launches2 = fused_gated_ffn_kernel.launches
    worst_e = max(parity_check(r.outputs, o) for r, o in zip(second, offline))
    bitwise_e = all(np.array_equal(a, b) for r, o in zip(second, offline)
                    for a, b in zip(r.outputs, o))
    log(f"[rollout] (e) SIGTERM at run-0's step 3: {[(r.reason, r.drained_at_step) for r in first]}"
        f"; persisted snapshots {[(r['session'], r['step']) for r in persisted]}, in the store "
        f"when each future resolved {stored_at_resolve}; launches {launches} over "
        f"{summary['dispatches']} dispatches; the fresh engine's weights equal: {same}; resumed "
        f"{[(r.reason, len(r.outputs)) for r in second]} in {summary2['dispatches']} dispatches, "
        f"launches {launches2}; prefix + resumed vs the uninterrupted offline rollout: worst "
        f"{worst_e:.3e} (bar {ROLLOUT_PARITY}), bitwise {bitwise_e}; store left {store.names()}")
    if (any(r.reason != "drained" or r.drained_at_step is None for r in first)
            or len(persisted) != 4 or not all(stored_at_resolve) or len(stored_at_resolve) != 4
            or not same or not all(r.ok and len(r.outputs) == k_steps for r in second)
            or worst_e > ROLLOUT_PARITY or store.names()
            or launches != per_forward * summary["dispatches"]
            or launches2 != per_forward * summary2["dispatches"]):
        raise RuntimeError("[rollout] (e) the drain and resume are not whole")
    out["sigterm_resume_serve_launches"] = launches + launches2

    # (f) Tenants on a direct server: interactive 3 : batch 1, batch's
    # quota 4; 48 one-shot requests, batch offered at 3x interactive, and
    # 4 interactive sessions; the metrics plane with tenant objectives.
    pol = TenantPolicy.from_specs(weights="interactive:3,batch:1", quotas="batch:4",
                                  priorities="interactive:interactive,batch:batch")
    sc = port_main.ServeConfig(metrics_interval_s=0.05, slo_p99_ms=1.0, slo_fast_window_s=0.1,
                               slo_slow_window_s=0.2)
    reg, sink = metrics_lib.MetricsRegistry(), ListSink()
    d = root / "f"
    publisher = metrics_lib.MetricsPublisher(
        reg, interval_s=sc.metrics_interval_s, sink=sink, series_path=str(d / "m.series.jsonl"),
        exposition_path=str(d / "m.prom"),
        evaluator=metrics_lib.SLOEvaluator(metrics_lib.default_objectives(sc)
                                           + metrics_lib.tenant_objectives(sc, pol.tenants)))
    srv = InferenceServer(InferenceEngine(model, batch_size=4), max_batch=4, max_wait_ms=2.0,
                          sink=sink, metrics=reg, tenants=pol).start(warmup=samples[:1])
    publisher.start()
    fused_gated_ffn_kernel.launches = 0
    sessions = [srv.submit_rollout(samples[i], 4, tenant="interactive") for i in range(4)]
    tagged = [("interactive" if i % 4 == 3 else "batch", srv.submit(samples[i % 16],
               tenant="interactive" if i % 4 == 3 else "batch")) for i in range(48)]
    results = [(t, f.result(timeout=120)) for t, f in tagged]
    sres = [f.result(timeout=120) for f in sessions]
    summary = srv.drain(60)
    launches = fused_gated_ffn_kernel.launches
    final = publisher.close()
    disagree = metrics_lib.summary_agrees(summary, final)
    quota = [r for r in sink.records if r["event"] == "tenant_quota_shed"]
    alerts = [(r["objective"], r["state"], r.get("tenant")) for r in sink.records
              if r["event"] == "slo_alert"]
    shed = {t: sum(not r.ok for tt, r in results if tt == t) for t in ("interactive", "batch")}
    ten = summary["tenants"]
    log(f"[rollout] (f) tenants: one-shot ok interactive "
        f"{sum(r.ok for t, r in results if t == 'interactive')}/12, batch "
        f"{sum(r.ok for t, r in results if t == 'batch')}/36 ({shed['batch']} shed_tenant_quota, "
        f"{len(quota)} tenant_quota_shed events); sessions {[r.reason for r in sres]}; tenants "
        f"{json.dumps({t: {k: v for k, v in st.items()} for t, st in ten.items()})}; slo_alert "
        f"edges {alerts}; summary_agrees {not disagree}; launches {launches} = {per_forward} x "
        f"{summary['dispatches']} dispatches on {card}")
    if (shed["interactive"] or not all(r.ok for r in sres) or len(quota) != shed["batch"]
            or ten["batch"]["shed"].get("shed_tenant_quota", 0) != shed["batch"]
            or any(ten[t]["latency_p99_ms"] is None for t in ("interactive", "batch"))
            or disagree or not any(t for _, _, t in alerts)
            or launches != per_forward * summary["dispatches"] or invalid(sink.records)):
        raise RuntimeError("[rollout] (f) the tenant plane is not whole")
    out["tenant_serve_launches"] = launches

    # (g) Costs. A step's host work: advance_sample, and the carry's round
    # trip (the next step's arrays to the card, an output back).
    dev = next(model.parameters()).device
    sample, output = samples[0], run_a.results[0].outputs[0]
    host = []
    for _ in range(200):
        t0 = time.perf_counter()
        nxt = advance_sample(sample, output)
        host.append((time.perf_counter() - t0) * 1e6)
    arrays = [nxt.coords, nxt.theta, *nxt.funcs]
    n_up = sum(a.nbytes for a in arrays)
    gpu_out = torch.from_numpy(output).to(dev)
    trip = []
    for _ in range(50):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a in arrays:
            torch.from_numpy(a).to(dev)
        gpu_out.cpu()
        torch.cuda.synchronize()
        trip.append((time.perf_counter() - t0) * 1e6)
    log(f"[rollout] (g) a step's host work: advance_sample median "
        f"{statistics.median(host):.1f} us; the carry's round trip ({n_up} B up in "
        f"{len(arrays)} arrays, {output.nbytes} B down) median {statistics.median(trip):.1f} us "
        f"on {card}")

    # A dispatch's kernel launch calls and synchronizing calls: four
    # 3-step sessions (3 full dispatches) and three groups of four one-shot
    # requests (3 full dispatches), in turns.
    def per_dispatch(mode: str):
        srv = InferenceServer(InferenceEngine(model, batch_size=4), max_batch=4,
                              max_wait_ms=10_000).start(warmup=samples[:1])

        def storm():
            if mode == "sessions":
                [f.result(timeout=120) for f in [srv.submit_rollout(s, 3) for s in samples[:4]]]
            else:
                for i in range(3):
                    submit_group(srv, samples[4 * i:4 * i + 4])

        busy, host_ms, records, calls = device_busy_ms(torch, storm)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                storm()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        summary = srv.drain(60)
        syncs = sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)
        n = summary["dispatches"] / 2  # two storms
        return (calls / n, syncs / n, records / n, round(busy / n, 3), round(host_ms / n, 3))

    turns = [(m, per_dispatch(m)) for m in ("one-shot", "sessions", "sessions", "one-shot")]
    log(f"[rollout] (g) a dispatch (4 rows), one-shot / sessions, turns of (kernel launch calls, "
        f"synchronizing calls, device records, device busy ms, host ms): {turns} on {card}")
    if len({t[1][:2] for t in turns}) != 1:
        raise RuntimeError(f"[rollout] (g) sessions changed a dispatch's launches or syncs: "
                           f"{turns}")

    # Step latency against one-shot latency, phase 4's traffic through main.
    one_shot, _ = run_observed(port_main, ROLLOUT_ARGV)
    log(f"[rollout] (g) latency p50 / p99: rollout steps (a) "
        f"{sess['step_latency_p50_ms']:.3f} / {sess['step_latency_p99_ms']:.3f} ms, one-shot "
        f"requests {one_shot.summary['latency_p50_ms']:.3f} / "
        f"{one_shot.summary['latency_p99_ms']:.3f} ms (host clock) on {card}")

    # The device's busy share during a rollout storm (16 sessions x 8 steps
    # on a direct server).
    srv = InferenceServer(InferenceEngine(model, batch_size=4), max_batch=4,
                          max_wait_ms=1.0).start(warmup=samples[:1])
    busy, host_ms, records, calls = device_busy_ms(
        torch, lambda: [f.result(timeout=120)
                        for f in [srv.submit_rollout(s, k_steps) for s in samples]])
    summary = srv.drain(60)
    log(f"[rollout] (g) a storm of 16 sessions x {k_steps} steps: {summary['dispatches']} "
        f"dispatches, device busy {busy:.3f} ms of {host_ms:.3f} ms host ({busy / host_ms:.1%} "
        f"busy), {records} device records, {calls} launch calls on {card}")
    return out


# -- phase 15: engine replicas and the router ------------------------------------


class OffsetClock:
    """The monotonic clock plus an offset a phase moves instead of sleeping."""

    def __init__(self):
        self.offset = 0.0

    def __call__(self) -> float:
        return time.monotonic() + self.offset


def stream_intervals(trace_path: Path, name: str | None = None) -> dict[int, list]:
    """Per CUDA stream of a ``torch.profiler`` Chrome trace, the (start,
    end) microseconds of its kernel records (only ``name``'s when given)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    out: dict[int, list] = {}
    for e in events:
        if "kernel" not in str(e.get("cat", "")).lower() or "dur" not in e:
            continue
        if name is not None and name not in str(e.get("name", "")):
            continue
        out.setdefault(int(e.get("args", {}).get("stream", -1)), []).append(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return out


def union_us(intervals: list) -> list:
    """Disjoint, sorted union of (start, end) intervals."""
    merged: list = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


def overlap_us(xs: list, ys: list) -> float:
    """Time two disjoint sorted interval lists have in common."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def router_phase(torch, np, card: str, layers) -> dict:
    """Phase 15: engine replicas and the router on the one card at phase
    4's configuration: (a) ``main --serve --serve_replicas 2`` in f32 (under
    a profile: the kernel on two streams) and in bf16; (b) one replica
    against two under the same 64-request storm; (c) a rolling reload with
    ``reload_corrupt`` on one replica; (d) ``replica_kill`` mid-rollout;
    (e) ``nan_output`` on replica 0's breaker; (f) ``remove_replica``
    mid-rollout and ``add_replica`` of a warmed replica. Returns the FFN
    kernel's launches over each path."""
    import shutil
    import threading
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from gnot_tpu_torch import main as port_main
    from gnot_tpu_torch.obs import events
    from gnot_tpu_torch.ops.fused_ffn import (
        fused_gated_ffn,
        fused_gated_ffn_kernel,
        fused_gated_ffn_reference,
    )
    from gnot_tpu_torch.resilience.faults import FaultInjector
    from gnot_tpu_torch.serve.engine import InferenceEngine
    from gnot_tpu_torch.serve.replica import build_replica, build_replicas
    from gnot_tpu_torch.serve.rollout import offline_rollout, parity_check
    from gnot_tpu_torch.serve.router import ReplicaRouter
    from gnot_tpu_torch.serve.server import CheckpointReloader, InferenceServer
    from gnot_tpu_torch.train.checkpoint import Checkpointer

    root = TRAIN_OUT / "router15"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    out: dict[str, int] = {}
    t_phase = time.perf_counter()

    def invalid(recs):
        return [(r, p) for r in recs if (p := events.validate_record(r))]

    def kinds(recs, kind):
        return [r for r in recs if r.get("event") == kind]

    # (a) The command line: two replicas on the card, f32 (profiled) and bf16.
    def main_run(tag: str, *flags: str, trace: Path | None = None):
        d = root / tag
        argv = SERVE13_ARGV + ["--serve_replicas", "2", "--metrics_path", str(d / "m.jsonl"),
                               *flags]
        args0 = ffn_inputs(torch, np, 1, 64, 256, 3, 5, seed=3)
        ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
               if trace is not None else contextlib.nullcontext())
        with ctx as prof:
            if trace is not None:
                # One launch on the default stream: the trace's control.
                fused_gated_ffn_kernel(*args0, gelu_kind="tanh")
                torch.cuda.synchronize()
            fused_gated_ffn_kernel.launches = 0
            fused_gated_ffn_kernel.launches_by_dtype = {}
            t0 = time.perf_counter()
            run, lines = run_observed(port_main, argv)
            launches = fused_gated_ffn_kernel.launches
            by_dtype = dict(fused_gated_ffn_kernel.launches_by_dtype)
            torch.cuda.synchronize()
        if trace is not None:
            prof.export_chrome_trace(str(trace))
        s = run.summary
        recs = read_jsonl(d / "m.jsonl")
        per_forward = 2 * run.model.config.n_attn_layers
        dispatches = s["dispatches"] + s["warmed_buckets"]
        per = s["per_replica"]
        log(f"[router] (a {tag}) python -m gnot_tpu_torch.main {' '.join(argv)}: "
            f"{time.perf_counter() - t0:.2f} s; launches {launches} = {per_forward} x "
            f"{dispatches} ({s['dispatches']} served + {s['warmed_buckets']} warm-ups over both "
            f"replicas), by dtype {by_dtype}; per replica (routed, completed, dispatches) "
            f"{[(p['routed'], p['completed'], p['dispatches']) for p in per.values()]}; "
            f"{len(kinds(recs, 'route'))} route events")
        for line in lines:
            if line.startswith(("Serve:", "WARNING")):
                log(f"[router]   {line}")
        if (len(run.results) != 16 or not all(r.ok for r in run.results)
                or launches != per_forward * dispatches or len(kinds(recs, "route")) != 16
                or sorted(per) != ["0", "1"] or not all(p["routed"] and p["completed"]
                                                       for p in per.values())
                or s["routing"]["replicas"] != 2 or invalid(recs)):
            raise RuntimeError(f"[router] (a {tag}) the replicated run is not whole: "
                               f"{[(r.reason, r.detail) for r in run.results if not r.ok]}")
        return run, launches, recs

    trace_a = root / "a_trace.json"
    run_a, launches, recs_a = main_run("f32", trace=trace_a)
    model, samples = run_a.model, run_a.samples
    per_forward = 2 * model.config.n_attn_layers
    plain = plain_outputs(torch, layers, model, samples)
    worst = hold_to_plain(np, "router", run_a.results, plain)
    by_stream = stream_intervals(trace_a, "fused_gated_ffn")
    control = min(by_stream, key=lambda k: len(by_stream[k]))  # the one default-stream launch
    replica_streams = sorted(k for k in by_stream if k != control)
    log(f"[router] (a f32) outputs vs a forward through the kernel's plain version: max_abs_err "
        f"{worst:.3e} (rtol {MODEL_RTOL} atol {MODEL_ATOL}); fused_gated_ffn kernel records by "
        f"stream id {{{', '.join(f'{k}: {len(v)}' for k, v in sorted(by_stream.items()))}}}, the "
        f"default stream's control launch on {control}")
    if (len(replica_streams) != 2 or len(by_stream[control]) != 1
            or sum(len(by_stream[k]) for k in replica_streams) < launches * 0.9):
        raise RuntimeError(f"[router] (a) the kernel's records are not on two replica streams: "
                           f"{ {k: len(v) for k, v in by_stream.items()} }")
    out["router_serve_launches"] = launches

    run_b, launches_b, _ = main_run("bf16", "--serve_dtype", "bfloat16")
    layers.fused_gated_ffn = fused_gated_ffn_reference
    try:
        plain_b = InferenceEngine(run_b.model, batch_size=4, dtype="bfloat16").predict(samples)
    finally:
        layers.fused_gated_ffn = fused_gated_ffn
    rel = float(np.linalg.norm(np.concatenate([r.output for r in run_b.results])
                               - np.concatenate(plain_b)) / np.linalg.norm(np.concatenate(plain_b)))
    log(f"[router] (a bf16) outputs vs the same bf16 forward through the kernel's plain version: "
        f"relative norm {rel:.3e} over all outputs (bar {BF16_PLAIN_REL})")
    if rel > BF16_PLAIN_REL or run_b.summary["dtype"] != "bfloat16":
        raise RuntimeError("[router] (a bf16) the replicated bf16 outputs are off their bar")
    out["router_bf16_serve_launches"] = launches_b

    # (b) One replica against two under one 64-request storm, in turns.
    storm = [samples[i % 16] for i in range(64)]

    def pool(n: int):
        if n == 1:
            srv = InferenceServer(InferenceEngine(model, batch_size=4), max_batch=4,
                                  max_wait_ms=2.0).start(warmup=samples[:1])
            return srv, [srv]
        reps = build_replicas(model, n, batch_size=4)
        for r in reps:
            r.warm(samples[:1], rows=4)
        router = ReplicaRouter(reps, max_batch=4, max_wait_ms=2.0).start()
        return router, [r.server for r in reps]

    def fire(front):
        return [f.result(timeout=120) for f in [front.submit(s) for s in storm]]

    def dispatched(servers) -> list[int]:
        return [s.summary()["dispatches"] for s in servers]

    turns = []
    for n in (1, 2, 2, 1):
        front, servers = pool(n)
        fire(front)  # a warm storm first
        d = root / f"b{len(turns)}"
        d.mkdir()
        d0 = dispatched(servers)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            results = fire(front)
            wall = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
        per = [b - a for a, b in zip(d0, dispatched(servers))]
        prof.export_chrome_trace(str(d / "trace.json"))
        calls = sum(e.count for e in prof.key_averages()
                    if e.key.startswith(("cudaLaunch", "cuLaunch")))
        busy_sum = sum(r[0] for r in kernel_rows(prof))
        streams = stream_intervals(d / "trace.json")
        unions = {k: union_us(v) for k, v in streams.items()}
        busy_union = sum(b - a for a, b in union_us([iv for v in streams.values() for iv in v])) / 1e3
        top2 = sorted(unions, key=lambda k: -sum(b - a for a, b in unions[k]))[:2]
        overlap = overlap_us(unions[top2[0]], unions[top2[1]]) / 1e3 if len(top2) == 2 else 0.0
        d1 = dispatched(servers)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fire(front)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        n_sync = sum(dispatched(servers)) - sum(d1)
        front.drain(60)
        # The host time of a dispatch on each replica, over the three storms.
        host_ms = [round(s.summary()["dispatch_ms_p50"], 3) for s in servers]
        syncs = sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)
        lat = sorted(r.latency_ms for r in results)
        if not all(r.ok for r in results):
            raise RuntimeError(f"[router] (b) {n} replica(s): a storm request failed")
        turns.append(dict(replicas=n, wall_ms=round(wall, 3), busy_sum_ms=round(busy_sum, 3),
                          busy_union_ms=round(busy_union, 3),
                          busy_share=round(busy_union / wall, 4),
                          overlap_ms=round(overlap, 3), p50_ms=round(lat[len(lat) // 2], 3),
                          p99_ms=round(lat[min(len(lat) - 1, int(0.99 * len(lat)))], 3),
                          dispatches_per_replica=per, dispatch_host_ms_p50=host_ms,
                          launch_calls_per_dispatch=round(calls / sum(per), 1),
                          syncs_per_dispatch=round(syncs / n_sync, 2)))
        log(f"[router] (b) {n} replica(s), 64 requests at once: {json.dumps(turns[-1])} on {card}")

    # (c) A rolling reload across both replicas under four closed-loop
    # clients (each sends its next request when its last one resolved, so
    # a shed can only come from the reload, not from an overfull queue),
    # reload_corrupt on replica 1: the source holds only 'latest' (a fresh
    # model from seed 1), so replica 0 takes it and replica 1's truncated
    # read finds nothing and keeps serving phase 4's weights.
    ck = root / "ck"
    latest_model = port_main.GNOT(model.config, generator=torch.Generator().manual_seed(1)).to(
        next(model.parameters()).device)
    ckpt = Checkpointer(str(ck))
    ckpt.save_latest({"model": latest_model.state_dict()}, 1, 0.5)
    ckpt.wait()
    latest = InferenceEngine(latest_model.eval(), batch_size=4)
    reps = build_replicas(model, 2, batch_size=4)
    for r in reps:
        r.warm(samples[:1], rows=4)
    sink = ListSink()
    router = ReplicaRouter(reps, max_batch=4, max_wait_ms=2.0, sink=sink,
                           reload_fn=CheckpointReloader(ckpt, model),
                           faults={1: FaultInjector.from_spec("reload_corrupt@1")}).start()
    group = samples[:4]
    before = [group_outputs(r.engine, group) for r in reps]
    want_latest = group_outputs(latest, group)
    fused_gated_ffn_kernel.launches = 0
    stop, results = threading.Event(), []

    def client(c: int):
        i = c
        while not stop.is_set():
            results.append(router.submit(samples[i % 16]).result(timeout=120))
            i += 4

    clients = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for t in clients:
        t.start()
    try:
        time.sleep(0.1)
        t0 = time.perf_counter()
        ok_n = router.reload()
        reload_s = time.perf_counter() - t0
        time.sleep(0.1)
    finally:
        stop.set()
        for t in clients:
            t.join(120)
    summary = router.drain(60)
    launches = fused_gated_ffn_kernel.launches
    after = [group_outputs(r.engine, group) for r in reps]
    edges = [(e["replica"], e["reason"]) for e in kinds(sink.records, "replica_health")]
    warming_now, warming_max = set(), 0
    for rid, reason in edges:
        if reason == "warming":
            warming_now.add(rid)
        else:
            warming_now.discard(rid)
        warming_max = max(warming_max, len(warming_now))
    rolling = [(e["replica"], e["ok"]) for e in kinds(sink.records, "rolling_reload")]
    same_1 = all(np.array_equal(a, b) for a, b in zip(after[1], before[1]))
    for a, b in zip(after[0], want_latest):
        np.testing.assert_allclose(a, b, rtol=MODEL_RTOL, atol=MODEL_ATOL)
    worst_0 = max(float(np.max(np.abs(a - b))) for a, b in zip(after[0], want_latest))
    log(f"[router] (c) rolling reload under {len(results)} requests: ok {ok_n}/2 in "
        f"{reload_s * 1e3:.1f} ms, rolling_reload {rolling}, health edges {edges}, at most "
        f"{warming_max} replica warming; shed {summary['shed']}; replica 1 (reload_corrupt, "
        f"kept its weights) outputs bitwise its own before: {same_1}; replica 0 vs an engine on "
        f"'latest': max abs {worst_0:.3e} (rtol {MODEL_RTOL} atol {MODEL_ATOL}); launches "
        f"{launches} = {per_forward} x {summary['dispatches']} dispatches on {card}")
    if (summary["shed"] or not all(r.ok for r in results) or ok_n != 1
            or rolling != [(0, True), (1, False)] or warming_max != 1 or not same_1
            or launches != per_forward * summary["dispatches"] or invalid(sink.records)):
        raise RuntimeError("[router] (c) the rolling reload is not whole")
    out["rolling_reload_serve_launches"] = launches

    # (d) replica_kill mid-rollout: four 8-step sessions, two a replica,
    # replica 0 killed at its third step's dispatch.
    reps = build_replicas(model, 2, batch_size=4)
    for r in reps:
        r.warm(samples[:1], rows=4)
    sink = ListSink()
    router = ReplicaRouter(reps, max_batch=4, max_wait_ms=2.0, sink=sink,
                           session_snapshot_every=2,
                           faults={0: FaultInjector.from_spec("replica_kill@5")})
    futs = [router.submit_rollout(s, ROLLOUT_K) for s in samples[:4]]
    fused_gated_ffn_kernel.launches = 0
    router.start()
    results = [f.result(timeout=120) for f in futs]
    summary = router.drain(60)
    launches = fused_gated_ffn_kernel.launches
    offline = [offline_rollout(reps[1].engine, s, ROLLOUT_K, rows=4) for s in samples[:4]]
    moves = [(e["session"], e["reason"], e["at_step"], e["replay_from"])
             for e in kinds(sink.records, "session_migrate")]
    bitwise = all(np.array_equal(a, b) for r, o in zip(results, offline)
                  for a, b in zip(r.outputs, o))
    worst_d = max(parity_check(r.outputs, o) for r, o in zip(results, offline))
    sess = summary["sessions"]
    log(f"[router] (d) replica_kill@5: {[(r.reason, len(r.outputs), r.migrations) for r in results]}"
        f"; session_migrate {moves}; sessions {json.dumps({k: v for k, v in sess.items() if 'ms' not in k})}; "
        f"vs offline_rollout on replica 1's engine: bitwise {bitwise}, worst {worst_d:.3e}; "
        f"launches {launches} = {per_forward} x {summary['dispatches']} dispatches")
    if (not all(r.ok and len(r.outputs) == ROLLOUT_K for r in results) or len(moves) != 2
            or sess["lost"] or not bitwise or launches != per_forward * summary["dispatches"]
            or invalid(sink.records)):
        raise RuntimeError("[router] (d) the migrated sessions are not whole")
    out["router_kill_serve_launches"] = launches

    # (e) nan_output on replica 0 under a threshold-1 breaker: its first
    # dispatch poisoned, the next requests on replica 1, then past the
    # cooldown the trial closes the breaker.
    clock = OffsetClock()
    reps = build_replicas(model, 2, batch_size=4)
    for r in reps:
        r.warm(samples[:1], rows=4)
    sink = ListSink()
    router = ReplicaRouter(reps, max_batch=4, max_wait_ms=1.0, sink=sink, breaker_threshold=1,
                           breaker_cooldown_s=0.5, clock=clock,
                           faults={0: FaultInjector.from_spec("nan_output@1")}).start()
    fused_gated_ffn_kernel.launches = 0
    first = router.submit(samples[0]).result(timeout=120)
    during = [router.submit(s).result(timeout=120) for s in samples[1:9]]
    clock.offset += 1.0
    trial = router.submit(samples[9]).result(timeout=120)
    summary = router.drain(60)
    launches = fused_gated_ffn_kernel.launches
    routes = [e["replica"] for e in kinds(sink.records, "route")]
    edges = [(e["replica"], e["reason"]) for e in kinds(sink.records, "replica_health")]
    log(f"[router] (e) nan_output@1 on replica 0: first {first.reason}, then "
        f"{[r.reason for r in during]} routed {routes}; health edges {edges}; trial "
        f"{trial.reason}, breaker {reps[0].server.breaker.state}, breaker events "
        f"{[e['event'] for e in sink.records if e['event'].startswith('breaker')]}; shed "
        f"{summary['shed']}; launches {launches} = {per_forward} x {summary['dispatches']}")
    if (first.reason != "error_nan_output" or not all(r.ok for r in during) or not trial.ok
            or routes != [0] + [1] * 8 + [0] or reps[0].server.breaker.state != "closed"
            or summary["shed"] != {"error_nan_output": 1}
            or launches != per_forward * summary["dispatches"] or invalid(sink.records)):
        raise RuntimeError("[router] (e) the breaker's drain and trial are not whole")
    out["router_breaker_serve_launches"] = launches

    # (f) remove_replica mid-rollout, then add_replica of a warmed replica.
    reps = build_replicas(model, 2, batch_size=4)
    for r in reps:
        r.warm(samples[:1], rows=4)
    sink = ListSink()
    router = ReplicaRouter(reps, max_batch=4, max_wait_ms=2.0, sink=sink,
                           session_snapshot_every=2).start()
    fused_gated_ffn_kernel.launches = 0
    futs = [router.submit_rollout(s, ROLLOUT_K) for s in samples[:4]]
    deadline = time.monotonic() + 60
    while reps[0].server.step_latency_histogram().count < 2 and time.monotonic() < deadline:
        time.sleep(0.001)
    removed = router.remove_replica(0, timeout_s=60)
    results = [f.result(timeout=120) for f in futs]
    fresh = build_replica(model, 2, next(model.parameters()).device, batch_size=4)
    warmed = fresh.warm(samples[:1], rows=4)
    router.add_replica(fresh)
    later = [f.result(timeout=120) for f in [router.submit(s) for s in samples[:8]]]
    summary = router.drain(60)
    launches = fused_gated_ffn_kernel.launches
    moves = [(e["session"], e["reason"], e["at_step"], e["replay_from"])
             for e in kinds(sink.records, "session_migrate")]
    offline = [offline_rollout(reps[1].engine, s, ROLLOUT_K, rows=4) for s in samples[:4]]
    worst_f = max(parity_check(r.outputs, o) for r, o in zip(results, offline))
    per = summary["per_replica"]
    log(f"[router] (f) remove_replica(0) mid-rollout: {[(r.reason, r.migrations) for r in results]}"
        f"; session_migrate {moves}; replica 0 retired with {removed['completed']} requests; "
        f"add_replica(2) warmed {warmed}: {kinds(sink.records, 'replica_warm')[0]['source']}; "
        f"8 requests after it routed {[e['replica'] for e in kinds(sink.records, 'route')][-8:]}; "
        f"per replica routed {({k: p['routed'] for k, p in per.items()})}; vs offline_rollout: "
        f"worst {worst_f:.3e}; launches {launches} = {per_forward} x ({summary['dispatches']} "
        f"dispatches + {warmed} warm-up)")
    if (not all(r.ok for r in results + later) or summary["sessions"]["lost"]
            or not moves or any(m[1] != "scale_in" or m[2] != m[3] for m in moves)
            or not per.get("2", {}).get("routed") or not per["0"].get("retired")
            or worst_f > ROLLOUT_PARITY
            or launches != per_forward * (summary["dispatches"] + warmed)
            or invalid(sink.records)):
        raise RuntimeError("[router] (f) the scale-in and scale-out are not whole")
    out["scale_serve_launches"] = launches
    log(f"[router] phase 15 took {time.perf_counter() - t_phase:.1f} s on {card}")
    return out


# -- phase 16: the program catalog and the autoscaler ------------------------------

# Phase 16 (b)'s command line: phase 4's traffic from one replica under the
# controller, a short tick and cooldown (flap window 0.3 s).
AUTOSCALE_FLAGS = ["--serve_replicas", "1", "--autoscale", "--autoscale_max", "3",
                   "--autoscale_interval_s", "0.02", "--autoscale_cooldown_s", "0.1",
                   "--autoscale_up_load", "4", "--autoscale_down_load", "1",
                   "--autoscale_down_ticks", "3", "--autoscale_heal_after_s", "0.5"]
# The ramp's burst: eight closed-loop clients, 12 requests each (six
# passes over the 16 requests): 8 in the system, twice --autoscale_up_load
# on one replica.
RAMP_CLIENTS = 8
RAMP = 96


class StampSink(ListSink):
    """A ``ListSink`` that stamps each record with the monotonic clock."""

    def log(self, **record) -> None:
        self.records.append({**record, "t": time.monotonic()})


def program_shape(key: str, plan) -> dict:
    """``program_costs``' shape arguments for a catalog program key."""
    kind, rest = key.split(":", 1)
    if kind == "packed":
        return {"plan": plan}
    dims, rows, _ = rest.split("@")
    pn, pf = dims.split("x")
    return {"rows": int(rows), "pad_nodes": int(pn), "pad_funcs": int(pf)}


def catalog_autoscale_phase(torch, np, card: str, layers) -> dict:
    """Phase 16: the program catalog and the autoscaler at phase 4's
    configuration on the one card: (a) phase 4's 16 requests through a
    single server and through two replicas, each with a
    ``ProgramCatalog``, in f32, bf16 and packed; (b) ``main --serve
    --autoscale`` from one replica under a ramp (a burst, then quiet) that
    scales out and back in; (c) ``replica_kill`` in a two-replica elastic
    pool under four closed-loop clients and four sessions, healed by a
    replacement; (d) (b)'s ramp through a static pool of
    ``--autoscale_max`` replicas, its replica-seconds and p99 beside the
    controller's. Returns the FFN kernel's launches over (a), (b) and (c)."""
    import shutil
    import threading

    from gnot_tpu_torch import main as port_main
    from gnot_tpu_torch.data.batch import PackPlan
    from gnot_tpu_torch.obs import events
    from gnot_tpu_torch.obs.costs import block_ffn_flops, program_costs
    from gnot_tpu_torch.ops.fused_ffn import fused_gated_ffn_kernel
    from gnot_tpu_torch.resilience.faults import FaultInjector
    from gnot_tpu_torch.serve.autoscaler import AutoscaleController
    from gnot_tpu_torch.serve.catalog import ProgramCatalog
    from gnot_tpu_torch.serve.engine import InferenceEngine
    from gnot_tpu_torch.serve.replica import build_replica, build_replicas
    from gnot_tpu_torch.serve.rollout import offline_rollout, parity_check
    from gnot_tpu_torch.serve.router import ReplicaRouter
    from gnot_tpu_torch.serve.server import InferenceServer

    root = TRAIN_OUT / "autoscale16"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    out: dict[str, int] = {}
    t_phase = time.perf_counter()

    def invalid(recs):
        return [(r, p) for r in recs if (p := events.validate_record(r))]

    def kinds(recs, kind):
        return [r for r in recs if r.get("event") == kind]

    args = port_main.build_parser().parse_args(SERVE13_ARGV)
    data, _ = port_main.configs_from_args(args)
    train_s, samples = port_main.datasets.load(data)
    mc = port_main.model_config(args, train_s)
    device = port_main.run_device(args)
    model = port_main.GNOT(mc, generator=torch.Generator().manual_seed(args.seed)).to(device)
    per_forward = 2 * mc.n_attn_layers
    plain = plain_outputs(torch, layers, model, samples)
    plain_bf16 = np.concatenate(plain_outputs(torch, layers, model, samples, "bfloat16"))
    # Phase 8's plan derivation (chunk 64, 4 samples a dispatch) over this
    # traffic.
    plan = PackPlan.for_slices(samples, chunk=64, batch_size=4, per_devices=1)
    # The fastest rate a program's products could reach on the card: in
    # f32 the FFN kernel's Linears at 3xTF32 on the tensor cores and every
    # other product (TF32 is off) and the gate's sum at the f32 CUDA-core
    # peak, weighted by the program's own flops; in bf16 the bf16 dense
    # peak. An achieved rate above it means the count or the time is wrong.
    def peak_rate(key: str, dtype: str, flops: int) -> tuple[float, str]:
        if dtype == "bfloat16":
            return PEAK_BF16_FLOPS, "bf16 dense"
        shape = program_shape(key, plan)
        tokens = (shape["plan"].n_rows * shape["plan"].row_len if "plan" in shape
                  else shape["rows"] * shape["pad_nodes"])
        linears, _ = block_ffn_flops(mc, tokens)
        ffn = mc.n_attn_layers * (2 if mc.n_input_functions else 1) * sum(linears)
        rate = flops / (ffn / (PEAK_TF32_FLOPS / 3) + (flops - ffn) / PEAK_F32_FLOPS)
        return rate, f"f32 mix ({ffn / flops:.1%} of flops at 3xTF32, the rest at f32)"

    # (a) The catalog: a single server and two replicas, f32, bf16, packed.
    def catalog_run(replicas: int, dtype: str, packed: bool) -> int:
        tag = f"{replicas} replica{'s' if replicas > 1 else ''} {dtype}{' packed' if packed else ''}"
        sink = ListSink()
        cat = ProgramCatalog(sink=sink)
        kw = dict(max_batch=4, max_wait_ms=2.0, sink=sink, catalog=cat,
                  pack_plan=plan if packed else None)
        fused_gated_ffn_kernel.launches = 0
        if replicas == 1:
            front = InferenceServer(InferenceEngine(model, batch_size=4, dtype=dtype), **kw)
            warmed = front.start(warmup=samples).warmed
        else:
            reps = build_replicas(model, replicas, batch_size=4, dtype=dtype)
            warmed = sum(r.warm(samples, rows=4, pack_plan=kw["pack_plan"]) for r in reps)
            front = ReplicaRouter(reps, **kw).start()
        results = [f.result(timeout=120) for f in [front.submit(s) for s in samples]]
        summary = front.drain(60)
        launches = fused_gated_ffn_kernel.launches
        model_ = summary["capacity_model"]
        progs = model_["programs"]
        entries = cat.entries()
        recorded = [(r["key"], r["costs"]) for r in kinds(sink.records, "program_catalog")]
        snapshots = kinds(sink.records, "capacity_snapshot")
        pad = summary["pad_waste_by_bucket"]
        lines, problems = [], []
        if sorted(k for k, _ in recorded) != sorted(entries) or len(snapshots) != 1:
            problems.append(f"events {[k for k, _ in recorded]} vs entries {sorted(entries)}, "
                            f"{len(snapshots)} capacity_snapshot")
        for key, costs in recorded:
            want = program_costs(mc, dtype=dtype, params=model.parameters(),
                                 **program_shape(key, plan))
            if costs != want:
                problems.append(f"{key}: recorded {costs} vs program_costs {want}")
        for key, p in progs.items():
            if not p["dispatches"]:
                continue
            bucket = key.split("@")[0].removeprefix("bucket:")
            st = pad.get(bucket, {})
            rate = p["flops_per_s"]
            peak, peak_name = peak_rate(key, dtype, p["costs"]["flops"])
            lines.append(
                f"{key}: {p['dispatches']} dispatches, {p['requests']} requests, "
                f"tokens_per_device_s {p['tokens_per_device_s']:.6g}, device_us_per_token "
                f"{p['device_us_per_token']:.6g}, flops {p['costs']['flops']} at "
                f"{rate:.6g} flops/s = {rate / peak:.4%} of the {peak:.4g} {peak_name} peak, "
                f"useful_token_frac {p['useful_token_frac']}")
            if (p["dispatches"] != st.get("dispatches") or p["useful_token_frac"] != st.get("fill_frac")
                    or not 0 < rate < peak):
                problems.append(f"{key}: {p} vs pad waste {st}")
        pool = model_["pool"]
        log(f"[catalog] (a {tag}) {len(results)} requests, {summary['dispatches']} dispatches, "
            f"{len(entries)} programs, launches {launches} = {per_forward} x "
            f"({summary['dispatches']} dispatches + {warmed} warm-ups); pool {pool['replicas']} "
            f"replicas, sustainable {pool['sustainable_requests_per_s']:.6g} requests/s, "
            f"{pool['sustainable_tokens_per_s']:.6g} tokens/s at 100% device duty; {card}")
        for line in lines:
            log(f"[catalog]   {line}")
        if dtype == "float32":
            hold_to_plain(np, f"catalog a {tag}", results, plain)
        else:  # phase 4b's bar: the relative norm against the bf16 plain forward
            got = np.concatenate([r.output for r in results])
            rel = float(np.linalg.norm(got - plain_bf16) / np.linalg.norm(plain_bf16))
            if rel > BF16_PLAIN_REL:
                problems.append(f"bf16 outputs {rel:.3e} from the plain forward")
        if (problems or not all(r.ok for r in results) or pool["dispatches"] != summary["dispatches"]
                or not pool["requests"] == summary["completed"] == 16 or pool["replicas"] != replicas
                or launches != per_forward * (summary["dispatches"] + warmed)
                or invalid(sink.records)):
            raise RuntimeError(f"[catalog] (a {tag}) the catalog does not agree: {problems}")
        return launches

    catalog_launches = 0
    for replicas in (1, 2):
        for dtype, packed in (("float32", False), ("bfloat16", False), ("float32", True)):
            catalog_launches += catalog_run(replicas, dtype, packed)
    out["catalog_serve_launches"] = catalog_launches

    # (b) Scale out and in through main, under a ramp: main's storm is
    # replaced by a burst of RAMP requests from RAMP_CLIENTS closed-loop
    # clients (request i is sample i mod 16), then quiet until the pool is
    # back at its floor (or 20 s); the controller closes before the drain,
    # as main's own storm closes it.
    ramp: dict = {}

    def ramp_storm(quiet_done):
        def storm(args_, sc, server, samples_, checkpointer, preempt, controller=None):
            results: list = [None] * RAMP

            def client(c):
                for i in range(c, RAMP, RAMP_CLIENTS):
                    results[i] = server.submit(samples_[i % len(samples_)]).result(timeout=120)

            ramp["t0"] = time.monotonic()
            clients = [threading.Thread(target=client, args=(c,)) for c in range(RAMP_CLIENTS)]
            for t in clients:
                t.start()
            for t in clients:
                t.join(300)
            ramp["t_burst"] = time.monotonic()
            while not quiet_done(controller, server) and time.monotonic() - ramp["t_burst"] < 20:
                time.sleep(0.005)
            ramp["t_end"] = time.monotonic()
            if controller is not None:
                controller.close()
            return server.drain(sc.drain_timeout_s), results
        return storm

    def ramp_run(tag: str, flags: list, quiet_done):
        d = root / tag
        storm = port_main._serve_storm
        port_main._serve_storm = ramp_storm(quiet_done)
        try:
            fused_gated_ffn_kernel.launches = 0
            run, lines = run_observed(port_main, SERVE13_ARGV + flags + [
                "--metrics_path", str(d / "m.jsonl")])
            launches = fused_gated_ffn_kernel.launches
        finally:
            port_main._serve_storm = storm
        s = run.summary
        warm = sum((p.get("warmup_cache") or {}).get("programs", 0)
                   for p in s["per_replica"].values())
        recs = read_jsonl(d / "m.jsonl")
        hold_to_plain(np, f"autoscale {tag}", run.results,
                      [plain[i % len(samples)] for i in range(RAMP)])
        if (not all(r is not None and r.ok for r in run.results)
                or not s["completed"] == s["requests"] == RAMP
                or s["shed"] or launches != per_forward * (s["dispatches"] + warm)
                or invalid(recs)):
            raise RuntimeError(f"[autoscale] ({tag}) the ramp is not whole: shed {s['shed']}, "
                               f"launches {launches} vs {per_forward} x ({s['dispatches']} + {warm})")
        return run, lines, recs, launches, warm

    run_b, lines_b, recs_b, launches_b, warm_b = ramp_run(
        "b", AUTOSCALE_FLAGS, lambda c, srv: c.stats()["scale_downs"] >= 1 and len(srv.pool()) == 1)
    span_b = ramp["t_end"] - ramp["t0"]
    quiet_b = ramp["t_end"] - ramp["t_burst"]
    s = run_b.summary
    manifest = json.load(open(root / "b" / "run.json"))
    ast = manifest["autoscale"]
    ups, downs = kinds(recs_b, "scale_up"), kinds(recs_b, "scale_down")
    order = []
    for up in ups:
        rid = up["replica"]
        warm_at = next(i for i, r in enumerate(recs_b)
                       if r.get("event") == "replica_warm" and r["replica"] == rid)
        route_at = next((i for i, r in enumerate(recs_b)
                         if r.get("event") == "route" and r["replica"] == rid), None)
        order.append((rid, up["reason"], warm_at, route_at))
    decisions = [(r["action"], r["reason"], r["pool"]) for r in kinds(recs_b, "autoscale_decision")]
    log(f"[autoscale] (b) python -m gnot_tpu_torch.main {' '.join(SERVE13_ARGV + AUTOSCALE_FLAGS)} "
        f"with a {RAMP}-request burst from {RAMP_CLIENTS} closed-loop clients, then quiet: "
        f"burst {ramp['t_burst'] - ramp['t0']:.3f} s, "
        f"quiet {quiet_b:.3f} s; decisions {decisions}; scale_up (replica, reason, replica_warm "
        f"record, first route record) {order}; scale_down {[(r['replica'], r['pool']) for r in downs]}"
        f"; shed {s['shed']}; {s['completed']}/{s['requests']} ok; per replica (routed, completed, "
        f"retired) {[(k, p['routed'], p['completed'], p.get('retired', False))
                     for k, p in s['per_replica'].items()]}"
        f"; launches {launches_b} = {per_forward} x ({s['dispatches']} dispatches + {warm_b} warm-ups"
        f"); run.json autoscale {json.dumps(ast)}")
    for line in lines_b:
        if line.startswith(("Serve:", "Autoscale:", "WARNING")):
            log(f"[autoscale]   {line}")
    # Every joining replica warmed before its first route; one at least was
    # routed (a replica joining as the burst ends may take none).
    if (not ups or not downs or any(r is not None and w > r for _, _, w, r in order)
            or all(r is None for _, _, _, r in order)
            or ast["scale_ups"] != len(ups) or ast["scale_downs"] != len(downs) or ast["errors"]):
        raise RuntimeError("[autoscale] (b) no scale-out warmed before it joined, or no scale-in")
    out["autoscale_serve_launches"] = launches_b

    # (c) Self-healing: replica_kill on replica 0 of a two-replica elastic
    # pool, four 8-step sessions (two a replica) and four closed-loop
    # clients; the controller replaces the dead replica under a fresh id on
    # its slot.
    def factory(rid, slot):
        return build_replica(model, rid, device, batch_size=4)

    reps = [factory(0, 0), factory(1, 1)]
    for r in reps:
        r.warm(samples[:1], rows=4)
    sink = StampSink()
    router = ReplicaRouter(reps, max_batch=4, max_wait_ms=2.0, sink=sink, session_snapshot_every=2,
                           wedge_after_s=60.0,
                           faults={0: FaultInjector.from_spec("replica_kill@5")})
    heal = AutoscaleController(router, replica_factory=factory, min_replicas=1, max_replicas=2,
                               interval_s=0.02, cooldown_s=0.1, heal_after_s=0.5,
                               warm_samples=samples[:1], sink=sink)
    futs = [router.submit_rollout(s_, ROLLOUT_K) for s_ in samples[:4]]
    fused_gated_ffn_kernel.launches = 0
    stop = threading.Event()
    client_results: list = []
    dead_at: list = []

    def client(i):
        n = 0
        while not stop.is_set():
            client_results.append(router.submit(samples[4 + (i + 4 * n) % 12]).result(timeout=120))
            n += 1

    def watch():
        while not stop.is_set() and reps[0].server.worker_alive():
            time.sleep(0.0005)
        dead_at.append(time.monotonic())

    threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(4)]
    watcher = threading.Thread(target=watch, daemon=True)
    router.start()
    heal.start()
    watcher.start()
    for t in threads:
        t.start()
    results = [f.result(timeout=120) for f in futs]
    deadline = time.monotonic() + 20
    while heal.stats()["replaces"] < 1 and time.monotonic() < deadline:
        time.sleep(0.005)
    stop.set()
    for t in threads + [watcher]:
        t.join(120)
    stats = heal.close()
    summary = router.drain(60)
    launches = fused_gated_ffn_kernel.launches
    replaced = kinds(sink.records, "replica_replace")
    removed = [r for r in kinds(sink.records, "replica_remove") if r["reason"] == "heal_dead"]
    moves = [(e["session"], e["reason"], e["at_step"], e["replay_from"])
             for e in kinds(sink.records, "session_migrate")]
    offline = [offline_rollout(reps[1].engine, s_, ROLLOUT_K, rows=4) for s_ in samples[:4]]
    bitwise = all(np.array_equal(a, b) for r, o in zip(results, offline)
                  for a, b in zip(r.outputs, o))
    worst_c = max(parity_check(r.outputs, o) for r, o in zip(results, offline))
    reasons: dict = {}
    for r in client_results:
        reasons[r.reason] = reasons.get(r.reason, 0) + 1
    new_warm = (router.pool()[-1].warm_stats or {}).get("programs", 0) if replaced else 0
    t_dead = dead_at[0] if dead_at else float("nan")
    after_remove = removed[0]["t"] - t_dead if removed else float("nan")
    after_replace = replaced[0]["t"] - t_dead if replaced else float("nan")
    sess = summary["sessions"]
    # A request placed on replica 0 just before the heal's removal drains it
    # lands on a draining server and is answered rejected_draining, in both
    # packages (tests/test_torch_router.py, removed_between_place_and_submit):
    # at most one a client, the one in flight at the removal.
    draining = reasons.get("rejected_draining", 0)
    log(f"[autoscale] (c) client requests in flight at the heal's removal, answered "
        f"rejected_draining: {draining} (at most the {len(threads)} clients)")
    log(f"[autoscale] (c) replica_kill@5 on replica 0 under 4 sessions and 4 closed-loop clients: "
        f"sessions {[(r.reason, len(r.outputs), r.migrations) for r in results]}; session_migrate "
        f"{moves}; replica_replace {[(e['from_replica'], e['to_replica'], e['reason']) for e in replaced]}"
        f" on slot {heal._slot_of.get(2)}; heal_dead removal {after_remove * 1e3:.1f} ms and the "
        f"replacement joined {after_replace * 1e3:.1f} ms after the worker died (heal_after_s 0.5, "
        f"tick 0.02 s); client requests by reason {reasons}; sessions lost {sess['lost']}; vs "
        f"offline_rollout on replica 1's engine: bitwise {bitwise}, worst {worst_c:.3e}; controller "
        f"{json.dumps(stats)}; launches {launches} = {per_forward} x ({summary['dispatches']} "
        f"dispatches + {new_warm} warm-up)")
    if (len(replaced) != 1 or (replaced[0]["from_replica"], replaced[0]["to_replica"]) != (0, 2)
            or heal._slot_of.get(2) != 0 or not after_remove <= 0.5 + 0.02
            or not after_replace <= 0.5 + 0.02
            or not all(r.ok and len(r.outputs) == ROLLOUT_K for r in results) or sess["lost"]
            or not bitwise or set(reasons) - {"ok", "error_replica_dead", "rejected_draining"}
            or draining > len(threads)
            or launches != per_forward * (summary["dispatches"] + new_warm)
            or invalid(sink.records)):
        raise RuntimeError("[autoscale] (c) the dead replica was not healed whole")
    out["heal_serve_launches"] = launches

    # (d) The replica-seconds ledger: (b)'s ramp through a static pool of
    # autoscale_max replicas, quiet for as long as (b) was.
    run_d, _, _, _, _ = ramp_run(
        "d", ["--serve_replicas", "3"],
        lambda c, srv: time.monotonic() - ramp["t_burst"] >= quiet_b)
    span_d = ramp["t_end"] - ramp["t0"]
    log(f"[autoscale] (d) replica-seconds: the controller {ast['replica_seconds']} over its "
        f"{span_b:.3f} s ramp (p99 {s['latency_p99_ms']:.3f} ms, p50 {s['latency_p50_ms']:.3f} ms) "
        f"vs a static pool of 3: {3 * span_d:.3f} (3 x {span_d:.3f} s; p99 "
        f"{run_d.summary['latency_p99_ms']:.3f} ms, p50 {run_d.summary['latency_p50_ms']:.3f} ms); "
        f"one card and the GIL, so no bar (phase 15); {card}")
    log(f"[autoscale] phase 16 took {time.perf_counter() - t_phase:.1f} s on {card}")
    return out


# -- phase 17: the federation and cluster tracing ------------------------------------

# Phase 17's federated runs: phase 4's traffic through main with the pool
# split into two loopback hosts of one replica each (the phase's flags and
# a metrics path are appended per run).
FEDERATION_ARGV = SERVE13_ARGV + ["--serve_replicas", "2", "--hosts", "2"]
# (d)'s leases: the control loop every 0.1 s, SUSPECT after 0.2 s and DEAD
# after 0.4 s of silence, above the worst dispatch wall PERF.md section 5
# records with two worker threads (~45 ms); an in-proc probe of a live
# host is answered inline, so a slow tick adds no silence. The dead bound
# must end before the victim's sessions do: its pool runs on after the
# kill (only the agent falls silent), and a session it completes deletes
# its persisted snapshot, leaving the survivor a restart from zero.
FEDERATION_LEASES = ["--heartbeat_interval_s", "0.1", "--suspect_after_s", "0.2",
                     "--dead_after_s", "0.4"]
# The first host to take its 12th inbound control message dies: its hello,
# its eight placements, then three heartbeats (~0.25 s into the storm, a
# step taking ~0.1 s), so its sessions are mid-rollout, past their first
# persisted snapshots.
FEDERATION_KILL = "host_kill@12"


def free_port_pair() -> int:
    """A loopback port p >= 1024 with p and p + 1 both free (host i of a
    TCP federation listens on p + i)."""
    import socket

    for _ in range(50):
        with socket.socket() as a:
            a.bind(("127.0.0.1", 0))
            p = a.getsockname()[1]
        if not 1024 <= p < 65535:
            continue
        with socket.socket() as b:
            try:
                b.bind(("127.0.0.1", p + 1))
            except OSError:
                continue
        return p
    raise RuntimeError("no free loopback port pair")


def trace_chains(merged: dict) -> tuple[dict, dict]:
    """A merged cluster trace's spans by trace id, as (source, span name)
    pairs, and each ``cluster_rollout`` span's session name -> trace id."""
    source = {e["pid"]: e["args"]["name"] for e in merged["traceEvents"] if e["ph"] == "M"}
    chains: dict[str, set] = {}
    sessions: dict[str, str] = {}
    for e in merged["traceEvents"]:
        if e["ph"] != "X":
            continue
        tid = e["args"]["trace_id"]
        chains.setdefault(tid, set()).add((source[e["pid"]], e["name"]))
        if e["name"] == "cluster_rollout":
            sessions[e["args"]["session"]] = tid
        if e["name"] == "placement":
            chains[tid].add(("placement", e["args"]["kind"], e["args"]["host"]))
    return chains, sessions


def federation_phase(torch, np, card: str, layers) -> dict:
    """Phase 17: the federation at phase 4's configuration, two loopback
    hosts of one replica each on the one card, through ``main --serve
    --serve_replicas 2 --hosts 2``: (a) in-proc links in f32, beside one
    router over two replicas; (b) loopback TCP (``--federation_port``);
    (c) bf16, with the merged cluster trace; (d) 8-step rollouts with a
    session store and ``host_kill`` under 0.1 / 0.2 / 0.4 s leases, traced
    (e) at rate 1 with the flight recorders on. Returns the FFN kernel's
    launches over (a), (b), (c) and (d)."""
    import shutil

    from gnot_tpu_torch import main as port_main
    from gnot_tpu_torch.obs import events
    from gnot_tpu_torch.ops.fused_ffn import fused_gated_ffn_kernel
    from gnot_tpu_torch.serve import federation as fed
    from gnot_tpu_torch.serve.engine import InferenceEngine
    from gnot_tpu_torch.serve.rollout import RolloutSession, SessionStore, offline_rollout

    root = TRAIN_OUT / "federation17"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    out: dict[str, int] = {}
    t_phase = time.perf_counter()

    def invalid(recs):
        return [(r, p) for r in recs if (p := events.validate_record(r))]

    def kinds(recs, kind):
        return [r for r in recs if r.get("event") == kind]

    def fed_run(tag: str, *flags: str):
        d = root / tag
        argv = FEDERATION_ARGV + ["--metrics_path", str(d / "m.jsonl"), *flags]
        fused_gated_ffn_kernel.launches = 0
        fused_gated_ffn_kernel.launches_by_dtype = {}
        t0 = time.perf_counter()
        run, lines = run_observed(port_main, argv)
        wall = time.perf_counter() - t0
        launches = fused_gated_ffn_kernel.launches
        by_dtype = dict(fused_gated_ffn_kernel.launches_by_dtype)
        s = run.summary
        recs = read_jsonl(d / "m.jsonl")
        per_forward = 2 * run.model.config.n_attn_layers
        hosts = {**s["per_host"], **s["drained_locally"]}
        dispatches = sum(h["dispatches"] for h in hosts.values())
        log(f"[federation] ({tag}) python -m gnot_tpu_torch.main {' '.join(argv)}: {wall:.2f} s; "
            f"launches {launches} = {per_forward} x ({dispatches} dispatches over hosts "
            f"{sorted(hosts)} + {s['warmed_buckets']} warm-ups), by dtype {by_dtype}; per host "
            f"(requests, completed, dispatches, p50, p99 ms) "
            f"{[(h, x['requests'], x['completed'], x['dispatches'], x['latency_p50_ms'], x['latency_p99_ms']) for h, x in sorted(hosts.items())]}")
        for line in lines:
            if line.startswith(("Federated serve:", "Wrote merged", "Flight recorder", "WARNING")):
                log(f"[federation]   {line}")
        if (len(run.results) != 16 or not all(r.ok for r in run.results)
                or launches == 0 or launches != per_forward * (dispatches + s["warmed_buckets"])
                or s["protocol_errors"] or len(kinds(recs, "cluster_summary")) != 1
                or invalid(recs)):
            raise RuntimeError(f"[federation] ({tag}) the federated run is not whole: "
                               f"{[(r.reason, r.detail) for r in run.results if not r.ok]}, "
                               f"launches {launches}, summary {json.dumps({k: v for k, v in s.items() if k != 'per_host'})}, "
                               f"invalid {invalid(recs)[:3]}")
        return run, recs, launches, by_dtype, wall

    def pct(values, q):
        return float(np.percentile(np.asarray(values), q))

    # (a) In-proc links, f32, beside one router over two replicas.
    base, _ = run_observed(port_main, SERVE13_ARGV + ["--serve_replicas", "2"])
    bs = base.summary
    run_a, recs_a, launches, by_dtype, wall_a = fed_run("a")
    s = run_a.summary
    worst = hold_to_plain(np, "federation a", run_a.results,
                          plain_outputs(torch, layers, run_a.model, run_a.samples))
    lat = [r.latency_ms for r in run_a.results]
    big = max(range(16), key=lambda i: run_a.samples[i].coords.shape[0])
    submit_b = len(fed.encode_frame(fed.wire(fed.SUBMIT, id="q00001",
                                             sample=fed.encode_sample(run_a.samples[big]))))
    result_b = len(fed.encode_frame(fed.wire(
        fed.RESULT, id="q00001", ok=True, reason="ok", output=fed._enc_arr(run_a.results[big].output),
        latency_ms=1.0, detail="")))
    log(f"[federation] (a) 16/16 ok, hosts_dead {s['hosts_dead']}, protocol_errors "
        f"{s['protocol_errors']}; vs a forward through the kernel's plain version: max abs "
        f"{worst:.3e} (rtol {MODEL_RTOL} atol {MODEL_ATOL}); host-server latency over the 16 "
        f"results p50 {pct(lat, 50):.3f} p99 {pct(lat, 99):.3f} ms, beside one router over two "
        f"replicas p50 {bs['latency_p50_ms']:.3f} p99 {bs['latency_p99_ms']:.3f} ms; largest "
        f"frames (full-width sample, base64 JSON) submit {submit_b} B, result {result_b} B of "
        f"MAX_FRAME_BYTES {fed.MAX_FRAME_BYTES} on {card}")
    if s["hosts_dead"] or by_dtype != {"f32": launches} or max(submit_b, result_b) > fed.MAX_FRAME_BYTES:
        raise RuntimeError("[federation] (a) a host died, a non-f32 launch, or a frame too large")
    out["federation_serve_launches"] = launches

    # (b) The same over loopback TCP.
    port = free_port_pair()
    run_b, _, launches, by_dtype, wall_b = fed_run("b", "--federation_port", str(port))
    worst_b = hold_to_plain(np, "federation b", run_b.results,
                            plain_outputs(torch, layers, run_b.model, run_b.samples))
    log(f"[federation] (b) over loopback TCP (ports {port}, {port + 1}): wall {wall_b:.2f} s vs "
        f"in-proc {wall_a:.2f} s; vs plain max abs {worst_b:.3e}; hosts_dead "
        f"{run_b.summary['hosts_dead']}")
    if run_b.summary["hosts_dead"] or by_dtype != {"f32": launches}:
        raise RuntimeError("[federation] (b) a host died or a non-f32 launch")
    out["federation_tcp_launches"] = launches

    # (c) bf16, with the merged cluster trace.
    trace_c = root / "c" / "t.json"
    run_c, _, launches, by_dtype, _ = fed_run("c", "--serve_dtype", "bfloat16", "--trace_path",
                                              str(trace_c), "--trace_sample_rate", "1")
    plain_c = plain_outputs(torch, layers, run_c.model, run_c.samples, dtype="bfloat16")
    rel = float(np.linalg.norm(np.concatenate([r.output for r in run_c.results])
                               - np.concatenate(plain_c)) / np.linalg.norm(np.concatenate(plain_c)))
    merged = json.loads(trace_c.read_text())
    chains, _ = trace_chains(merged)
    whole = [t for t, c in chains.items()
             if {("controller", "placement"), ("controller", "cluster_request")} <= c
             and any(src.startswith("host") and n == "dispatch" for src, n, *_ in c)]
    sources = sorted(merged["otherData"]["hosts"])
    log(f"[federation] (c) bf16: launches by dtype {by_dtype}; vs the bf16 forward through the "
        f"kernel's plain version: relative norm {rel:.3e} (bar {BF16_PLAIN_REL}); merged trace "
        f"sources {sources}, {len(chains)} trace ids, {len(whole)} stitched chains "
        f"(placement -> cluster_request -> a host's serve spans)")
    if (by_dtype != {"bf16": launches} or rel > BF16_PLAIN_REL
            or sources != ["controller", "host0", "host1"] or len(whole) != 16
            or len(chains) != 16 or run_c.summary["hosts_dead"]):
        raise RuntimeError("[federation] (c) the bf16 run or its merged trace is not whole")
    out["federation_bf16_launches"] = launches

    # (d) host_kill during rollouts, (e) traced, with the flight recorders.
    d = root / "d"
    run_d, recs_d, launches, by_dtype, _ = fed_run(
        "d", "--serve_rollout_steps", str(ROLLOUT_K), "--session_dir", str(d / "sessions"),
        "--serve_inject_fault", FEDERATION_KILL, *FEDERATION_LEASES, "--trace_path",
        str(d / "t.json"), "--trace_sample_rate", "1", "--flight_recorder_s", "5")
    s = run_d.summary
    [dead] = kinds(recs_d, "host_dead") or [None]
    remig = kinds(recs_d, "session_remigrate")
    victim = dead["host"] if dead else None
    engine = InferenceEngine(run_d.model, batch_size=4)
    offline = [offline_rollout(engine, x, ROLLOUT_K, rows=4) for x in run_d.samples]
    bitwise = all(len(r.outputs) == ROLLOUT_K and all(np.array_equal(a, b) for a, b in zip(
        r.outputs, o)) for r, o in zip(run_d.results, offline))
    store = SessionStore(str(d / "persist_probe"))
    probe = RolloutSession("probe", run_d.samples[0], ROLLOUT_K)
    for o in run_d.results[0].outputs:
        probe.record_step(o)
    probe.take_snapshot()
    save_ms = []
    for _ in range(21):
        t0 = time.perf_counter()
        store.save(probe)
        save_ms.append((time.perf_counter() - t0) * 1e3)
    done_b = len(fed.encode_frame(fed.wire(
        fed.ROLLOUT_DONE, id="s00001", ok=True, reason="ok", steps_completed=ROLLOUT_K,
        migrations=1, drained_at_step=None, detail="",
        outputs=[fed._enc_arr(o) for o in run_d.results[0].outputs])))
    log(f"[federation] (d) {FEDERATION_KILL}: host_dead {victim} after silent_s "
        f"{dead['silent_s'] if dead else None} s from its first unanswered probe (its last ack "
        f"came at most one 0.1 s tick before that probe), its "
        f"{dead['sessions'] if dead else None} sessions -> {len(remig)} session_remigrate "
        f"{[(e['session'], e['at_step'], e['replay_from']) for e in remig]}; summary sessions "
        f"{s['sessions']} completed {s['completed']} remigrated {s['remigrated']} lost {s['lost']}; "
        f"every trajectory bitwise offline_rollout on the card: {bitwise}; SessionStore.save of "
        f"a due snapshot (host time, the carry and {ROLLOUT_K} outputs already on the host): "
        f"median {statistics.median(save_ms):.3f} ms, max {max(save_ms):.3f} ms; the "
        f"rollout_done frame {done_b} B")
    if (not dead or s["hosts_dead"] != 1 or len(remig) != dead["sessions"] or not remig
            or s["remigrated"] != len(remig) or s["lost"] or not bitwise
            or any(e["from_host"] != victim for e in remig) or by_dtype != {"f32": launches}):
        raise RuntimeError("[federation] (d) the host death is not survived whole")
    out["federation_kill_launches"] = launches

    merged = json.loads((d / "t.json").read_text())
    chains, by_session = trace_chains(merged)
    survivor = "host1" if victim == "host0" else "host0"
    sources = sorted(merged["otherData"]["hosts"])
    moved = {e["session"] for e in remig}
    joined = [n for n in moved if n in by_session and
              ("placement", "remigrate", survivor) in chains[by_session[n]]
              and (survivor, "dispatch") in chains[by_session[n]]]
    stitched = [n for n, t in by_session.items()
                if {("controller", "placement"), ("controller", "cluster_rollout")} <= chains[t]
                and (survivor, "dispatch") in chains[t]]
    on_victim_only = sorted(set(by_session) - set(stitched))
    restarted = sorted(n for n in moved if n in by_session and any(
        c[:2] == ("placement", "restart") for c in chains[by_session[n]]))
    dumps = sorted(p.name for p in d.glob("flight_*.json"))
    dump = json.loads((d / dumps[0]).read_text()) if dumps else {}
    log(f"[federation] (e) merged trace sources {sources} (the killed host answers no "
        f"trace_pull); {len(by_session)} session traces, {len(stitched)} stitched to "
        f"{survivor}'s serve spans, {len(on_victim_only)} served whole on {victim} before its "
        f"death {on_victim_only}; re-migrated sessions whose resumed steps joined their original "
        f"trace {len(joined)}/{len(moved)}, of them restarted from zero (no snapshot left) "
        f"{len(restarted)}; flight recorder dumps {dumps} (ring of "
        f"{dump.get('host')}, trigger {dump.get('trigger', {}).get('kind')} "
        f"{dump.get('trigger', {}).get('host')}, {len(dump.get('entries', []))} entries)")
    if (sources != sorted(["controller", survivor]) or len(by_session) != 16
            or len(joined) != len(moved) or len(stitched) + len(on_victim_only) != 16
            or not all(n not in moved and ("placement", "place", victim) in chains[by_session[n]]
                       for n in on_victim_only)
            or len(dumps) != 1 or dump.get("host") != "controller"
            or dump["trigger"]["kind"] != "host_dead" or dump["trigger"].get("host") != victim):
        raise RuntimeError("[federation] (e) the merged trace or the flight recorder is not whole")
    log(f"[federation] phase 17 took {time.perf_counter() - t_phase:.1f} s on {card}")
    return out


# --------------------------------------------------------------------------
# Phase 18: parallel training over torch.distributed (ranks as processes).
# --------------------------------------------------------------------------

# The reference-default width of phase 6, with the FFN on the torch path:
# ffn_impl='pallas' is refused on a mesh, in both packages.
PAR_ARGV = ["--synthetic", "ns2d", "--n_train", "16", "--n_test", "8", "--epochs", "2",
            "--batch_size", "4", "--ffn_impl", "xla", "--device", "cuda", "--distributed"]
# Every mesh's losses against the mesh of one, and the mesh of one against
# the run without --distributed: another summation order of the same sums.
PAR_RTOL = 1e-5
# fused_nla_sp against fused_nla and the plain reference_impl: the JAX
# package's bar (tests/test_pallas.py:147-215).
SP_RTOL, SP_ATOL = 1e-5, 1e-6
# Each rank's own deadline; the group's collectives wait at most
# GNOT_DIST_TIMEOUT_S.
RANK_TIMEOUT_S = 240
PAR_OUT = TRAIN_OUT / "parallel"


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(world: int, port: int, rank: int | None = None) -> dict:
    """``torchrun``'s environment for one rank of a one-node launch (with
    ``rank`` None, what ``torchrun`` itself is given)."""
    env = dict(os.environ, GNOT_DIST_TIMEOUT_S="120", OMP_NUM_THREADS="1")
    if rank is not None:
        env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(world), GROUP_RANK="0", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
    return env


def wait_all(procs: list, tag: str, timeout_s: float = RANK_TIMEOUT_S) -> list[str]:
    """Every process's output, each waited for with the one deadline; on a
    timeout or a failure every process (and its session) is killed and the
    phase fails."""
    import signal as signal_lib

    deadline = time.monotonic() + timeout_s
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        outs = None
    finally:
        for p in procs:
            if p.poll() is None:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(p.pid, signal_lib.SIGKILL)
                p.wait()
    if outs is None:
        raise RuntimeError(f"[par] {tag}: still running after {timeout_s} s; killed")
    for p, out in zip(procs, outs):
        if p.returncode:
            raise RuntimeError(f"[par] {tag}: a process exited {p.returncode}:\n{out[-4000:]}")
    return outs


def popen(cmd: list[str], env: dict):
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)


def launch_ranks(world: int, args: list[str], tag: str) -> list[str]:
    """``world`` processes of this script's rank mode, one a rank."""
    port = free_port()
    return wait_all([popen([sys.executable, str(Path(__file__).resolve()), "--rank", *args],
                           rank_env(world, port, r)) for r in range(world)], tag)


def torchrun(nproc: int, args: list[str], tag: str) -> str:
    """One ``torchrun --nproc_per_node nproc`` launch of ``args``."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(nproc),
           "--master_port", str(free_port()), *args]
    return wait_all([popen(cmd, rank_env(nproc, 0))], tag)[0]


def sp_inputs(torch, np, kind: str):
    """Phase 18 (a)'s inputs on the card: q [4,1024,256], H=8, and the
    NS2d-1k cross k/v [1,4,512,256] (a random key mask, row 0 kept) or
    the self k/v from q's own rows."""
    rng = np.random.default_rng(18)
    q = rng.standard_normal((4, 1024, 256), dtype=np.float32)
    lk = 512 if kind == "cross" else 1024
    k = rng.standard_normal((1, 4, lk, 256), dtype=np.float32)
    v = rng.standard_normal((1, 4, lk, 256), dtype=np.float32)
    mask = (rng.uniform(size=(1, 4, lk)) > 0.2).astype(np.float32)
    mask[:, :, 0] = 1.0
    return [torch.from_numpy(t).cuda() for t in (q, k, v, mask)]


def sp_call(torch, fn, q, k, v, mask):
    """``fn``'s (out, qs) and the gradients wrt q, k, v of ``sum(out^2) +
    sum(qs / 2)`` (``tests/test_pallas.py``'s loss)."""
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out, qs = fn(*leaves, mask)
    (torch.sum(out**2) + torch.sum(qs * 0.5)).backward()
    return out.detach(), qs.detach(), [t.grad for t in leaves]


def sp_cases(out_dir: Path) -> None:
    """Phase 18 (a) on this rank, in the group it joined: ``fused_nla_sp``
    over the seq axis of every rank, the CUDA kernels on each, with psum
    and with the ring; its blocks, its gradient parts, its launches and its
    time, saved to ``out_dir/sp<rank>.pt``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from gnot_tpu_torch.config import MeshConfig
    from gnot_tpu_torch.ops import fused_attention as fa
    from gnot_tpu_torch.parallel.mesh import make_mesh

    rank, world = dist.get_rank(), dist.get_world_size()
    res = {"backend": dist.get_backend(), "device": str(torch.cuda.current_device()),
           "cases": {}}
    mesh = make_mesh(MeshConfig(seq=world))
    for kind in ("cross", "self"):
        q, k, v, mask = sp_inputs(torch, np, kind)
        for coll in ("psum", "ring"):
            fn = lambda *a, c=coll: fa.fused_nla_sp(*a, 8, mesh, sp_collective=c)  # noqa: E731
            fa.nla_reduce_kernel.launches = fa.nla_apply_kernel.launches = 0
            out, qs, grads = sp_call(torch, fn, q, k, v, mask)
            torch.cuda.synchronize()
            launches = [fa.nla_reduce_kernel.launches, fa.nla_apply_kernel.launches]
            with torch.no_grad():
                for _ in range(3):
                    fn(q, k, v, mask)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(10):
                    fn(q, k, v, mask)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) / 10 * 1e3
            res["cases"][f"{kind}/{coll}"] = {
                "coords": mesh.coords, "shape": mesh.shape, "out": out.cpu(),
                "qs": qs.cpu(), "grads": [g.cpu() for g in grads],
                "launches": launches, "ms": ms}
    torch.save(res, out_dir / f"sp{rank}.pt")


def rank_main(plan_path: Path) -> None:
    """A rank of phases 18 and 21, its plan in ``plan_path`` and its results
    beside it (``<plan>_rank<r>.json``): with ``plan["sp"]`` (a) first
    (``sp_cases``), then each run of ``plan["runs"]`` through the port's
    entry point (``gnot_tpu_torch.main.run``) in this rank's process, in
    the one process group this rank joins first; per training run its
    losses, metrics, peak device memory, the parity merge's all-gathers,
    and with ``profile`` its all-reduce time a step from the
    ``torch.profiler`` trace of epoch 1. ``sigterm_rank`` gives that rank
    alone ``--inject_fault sigterm@3`` (a real SIGTERM to its process
    before step 3); ``carry_on`` then trains the stopped trainer on from its
    epoch in memory (no checkpoint in between). ``bucketed`` keeps the
    loaders' bucketing on in parity mode (the API's default; the command
    line turns it off, and the seq axis needs bucketed lengths). A serving
    run (``--serve``) records rank 0's summary and its outputs
    (``<run>/outputs.npz``) or a follower's counters; ``sigterm_submit`` N
    sends rank 0 a SIGTERM as it submits its N-th request."""
    import signal as signal_lib

    import numpy as np
    import torch

    from gnot_tpu_torch import main as port_main
    from gnot_tpu_torch.ops import collectives
    from gnot_tpu_torch.ops import fused_attention as fa
    from gnot_tpu_torch.ops.fused_ffn import fused_gated_ffn_kernel
    from gnot_tpu_torch.parallel import multihost
    from gnot_tpu_torch.serve.server import InferenceServer

    plan = json.loads(plan_path.read_text())
    out_dir = plan_path.parent
    multihost.initialize(torch.device("cuda"))
    rank = multihost.process_index()
    results = {}
    data_config, submit = port_main.data_config, InferenceServer.submit
    try:
        if plan.get("sp"):
            sp_cases(out_dir)
        for run in plan["runs"]:
            name, argv = run["name"], list(run["argv"])
            if rank == 0:
                argv += ["--metrics_path", str(out_dir / name / "m.jsonl")]
            if run.get("profile"):
                argv += ["--profile_dir", str(out_dir / name / f"prof{rank}")]
            if run.get("sigterm_rank") == rank:
                argv += ["--inject_fault", "sigterm@3"]
            port_main.data_config = ((lambda args: dataclasses.replace(data_config(args),
                                                                      bucket=True))
                                     if run.get("bucketed") else data_config)
            if run.get("sigterm_submit") and rank == 0:
                calls = []

                def submit_then_signal(server, sample, _n=run["sigterm_submit"], **kw):
                    calls.append(1)
                    if len(calls) == _n:
                        os.kill(os.getpid(), signal_lib.SIGTERM)
                    return submit(server, sample, **kw)

                InferenceServer.submit = submit_then_signal
            else:
                InferenceServer.submit = submit
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            collectives.reset_hop_stats()
            collectives.reset_gather_stats()
            kernels = [fused_gated_ffn_kernel, fa.nla_reduce_kernel, fa.nla_apply_kernel,
                       fa.nla_reduce_seg_kernel, fa.nla_apply_seg_kernel]
            launched = sum(k.launches for k in kernels)
            t0 = time.perf_counter()
            console = io.StringIO()
            with (contextlib.redirect_stdout(console) if "--serve" in argv
                  else contextlib.nullcontext()):
                result = port_main.run(argv)
            torch.cuda.synchronize()
            res = {"wall_s": time.perf_counter() - t0,
                   "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
                   "kernel_launches": sum(k.launches for k in kernels) - launched,
                   "gathers": dict(collectives.GATHER_STATS)}
            if isinstance(result, port_main.ServeRun):
                if result.follower is not None:
                    res["follower"] = result.follower
                else:
                    res["summary"] = result.summary
                    res["ok"] = [r.ok for r in result.results]
                    res["console"] = console.getvalue()[-2000:]
                    np.savez(out_dir / name / "outputs.npz",
                             *[r.output for r in result.results if r.ok])
                results[name] = res
                continue
            trainer = result
            res.update({"mesh": trainer.mesh.shape, "host_step": trainer.host_step,
                        "losses": [h.step_losses.tolist() for h in trainer.history],
                        "metrics": [h.test_metric for h in trainer.history],
                        "hops": dict(collectives.HOP_STATS),
                        "micro": getattr(trainer.model, "n_micro", 0)})
            if run.get("profile"):
                res["allreduce_ms"] = allreduce_ms(out_dir / name / f"prof{rank}" / "epoch_1.trace.json")
            if run.get("carry_on"):
                # run() closed its sink and tracer; no checkpoint in between.
                trainer.checkpointer = trainer.metrics_sink = trainer._tracer = None
                trainer.start_epoch = len(trainer.history)
                trainer.fit()
                res["carried"] = {"losses": [h.step_losses.tolist() for h in trainer.history],
                                  "metrics": [h.test_metric for h in trainer.history],
                                  "host_step": trainer.host_step}
            params = trainer.standard_params()
            res["param_sum"] = float(sum(np.float64(p.double().sum().item())
                                         for p in params.values()))
            results[name] = res
    finally:
        port_main.data_config, InferenceServer.submit = data_config, submit
        multihost.shutdown()
    plan_path.with_name(f"{plan_path.stem}_rank{rank}.json").write_text(json.dumps(results))


def allreduce_ms(trace: Path) -> dict:
    """The all-reduces of a ``torch.profiler`` trace of one epoch: the
    calls through the process group (``c10d::allreduce_``; for gloo, the
    enqueue) and the wall time covered by gloo's records of the work
    (``gloo:all_reduce``, two nested records a call: the union of their
    intervals, so none counts twice)."""
    events = [e for e in json.load(open(trace))["traceEvents"] if "dur" in e]
    calls = [e for e in events if e.get("name") == "c10d::allreduce_"]
    work = union_us([(e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("name") == "gloo:all_reduce"])
    return {"calls": len(calls), "ms": sum(b - a for a, b in work) / 1e3}


def rank_entry(argv: list[str]) -> int:
    """``chip_smoke.py --rank PLAN_JSON``: one rank of phase 18, with
    ``torchrun``'s environment."""
    sys.path.insert(0, str(ROOT))
    rank_main(Path(argv[0]))
    return 0


def epoch_records(path: Path) -> list[dict]:
    return [r for r in read_jsonl(path) if "train_loss" in r]


def rel_diff(np, a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12)))


def par_results(out_dir: Path, launches: list) -> dict[str, list]:
    """Every rank's results of each ``(world, plan)`` launch (written under
    ``out_dir`` as ``plan<i>_rank<r>.json``), by run name, in rank order."""
    results = {}
    for i, (world, _) in enumerate(launches):
        for r in range(world):
            path = out_dir / f"plan{i}_rank{r}.json"
            for name, res in json.loads(path.read_text()).items():
                results.setdefault(name, []).append(res)
    return results


def parallel_phase(torch, np, card: str) -> dict:
    """Phase 18: parallel training over torch.distributed on the one card.
    (a) ``fused_nla_sp`` over 2 ranks sharing the card (gloo with CUDA
    tensors), psum and ring, cross and self, held against ``fused_nla``
    and ``reference_impl``; a world of one. (b) ``torchrun
    --nproc_per_node 1 -m gnot_tpu_torch.main --distributed`` (NCCL, a
    mesh of one) against the run without ``--distributed``. (c) the same
    flags on 2 ranks with --mesh_data / --mesh_seq / --mesh_model 2 and on
    3 ranks with --mesh_expert 3, against (b), with each rank's step time,
    all-reduce time a step and peak memory. (d) SIGTERM to rank 1 alone of
    a --mesh_seq 2 run: both stop at one step and rank 0 saves; --resume
    from it ends bitwise where the stopped run carried on in memory ends."""
    from gnot_tpu_torch import main as port_main
    from gnot_tpu_torch.config import MeshConfig
    from gnot_tpu_torch.ops import fused_attention as fa
    from gnot_tpu_torch.parallel.mesh import make_mesh

    import shutil

    t_phase = time.monotonic()
    shutil.rmtree(PAR_OUT, ignore_errors=True)
    PAR_OUT.mkdir(parents=True)
    out = {}

    # (a), (c) and (d)'s stop on 2 ranks sharing the card; (c) on 3 ranks;
    # then (d)'s resume in a fresh launch beside (b): the mesh of one on NCCL
    # (torchrun) and the run without --distributed (in this process). (b)
    # and the resume time nothing, so they share the card.
    t0 = time.monotonic()
    for d in ("b", "data2", "seq2", "model2", "expert3", "stop", "resume"):
        (PAR_OUT / d).mkdir()
    ck = PAR_OUT / "ck"
    # The model and expert runs also save checkpoints: the shards gathered
    # over gloo with CUDA tensors, rank 0 writing.
    two = [dict(name=f"{axis}2", argv=PAR_ARGV + [f"--mesh_{axis}", "2"] + (
        ["--checkpoint_dir", str(PAR_OUT / "ck_model2")] if axis == "model" else []),
        profile=True) for axis in ("data", "seq", "model")]
    two.append(dict(name="stop", argv=PAR_ARGV + ["--mesh_seq", "2", "--checkpoint_dir",
                                                  str(ck)], sigterm_rank=1, carry_on=True))
    three = [dict(name="expert3", argv=PAR_ARGV + ["--mesh_expert", "3", "--checkpoint_dir",
                                                   str(PAR_OUT / "ck_expert3")], profile=True)]
    resume = [dict(name="resume", argv=PAR_ARGV + ["--mesh_seq", "2", "--checkpoint_dir",
                                                   str(ck), "--resume"])]
    launches = [(2, dict(sp=True, runs=two)), (3, dict(runs=three)), (2, dict(runs=resume))]
    for i, (world, plan) in enumerate(launches):
        (PAR_OUT / f"plan{i}.json").write_text(json.dumps(plan))
    launch_ranks(2, [str(PAR_OUT / "plan0.json")], "a, c, d")
    launch_ranks(3, [str(PAR_OUT / "plan1.json")], "c")
    port = free_port()
    procs = [popen([sys.executable, str(Path(__file__).resolve()), "--rank",
                    str(PAR_OUT / "plan2.json")], rank_env(2, port, r)) for r in range(2)]
    procs.append(popen([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1",
                        "--master_port", str(free_port()), "-m", "gnot_tpu_torch.main",
                        *PAR_ARGV, "--metrics_path", str(PAR_OUT / "b" / "m.jsonl")],
                       rank_env(1, 0)))
    try:
        plain_argv = [a for a in PAR_ARGV if a != "--distributed"]
        with contextlib.redirect_stdout(io.StringIO()):
            base = port_main.run(plain_argv + ["--metrics_path", str(PAR_OUT / "base.jsonl")])
    finally:
        text = wait_all(procs, "d, b")[-1]
    log(f"[par] four launches (a, c, d, b) {time.monotonic() - t0:.1f} s")
    results = par_results(PAR_OUT, launches)

    # (b) the mesh of one against the run without --distributed.
    base_recs = epoch_records(PAR_OUT / "base.jsonl")
    if "Distributed: backend=nccl ranks=1" not in text:
        raise RuntimeError(f"[par] (b) not a mesh of one on NCCL:\n{text[-2000:]}")
    one_recs = epoch_records(PAR_OUT / "b" / "m.jsonl")
    keys = ("train_loss", "test_metric")
    b_vals = [r[k] for r in one_recs for k in keys]
    b_diff = rel_diff(np, b_vals, [r[k] for r in base_recs for k in keys])
    log(f"[par] (b) torchrun --nproc_per_node 1 -m gnot_tpu_torch.main {' '.join(PAR_ARGV)}: "
        f"train/test {b_vals} vs without --distributed: max rel diff {b_diff:.3e} (bar "
        f"{PAR_RTOL}); best {base.best_metric}")
    if b_diff > PAR_RTOL:
        raise RuntimeError("[par] (b) the mesh of one is not the single-device run")

    # (a) fused_nla_sp: the ranks' blocks against fused_nla and the plain
    # version on the whole inputs, and a world of one.
    ranks = [torch.load(PAR_OUT / f"sp{r}.pt", weights_only=False) for r in range(2)]
    log(f"[par] (a) 2 ranks on cuda:{[r['device'] for r in ranks]} backend "
        f"{ranks[0]['backend']}; the ring stages each hop through host memory: gloo's TCP "
        "transport writes a CUDA tensor's device pointer as a host address (EFAULT, 'Bad "
        "address', on the next collective)")
    world_one = make_mesh(MeshConfig())
    sp_launches = [0, 0]
    worst = {"kernel": 0.0, "plain": 0.0}
    for kind in ("cross", "self"):
        q, k, v, mask = sp_inputs(torch, np, kind)
        fa.nla_reduce_kernel.launches = fa.nla_apply_kernel.launches = 0
        k_out, k_qs, k_grads = sp_call(torch, lambda *a: fa.fused_nla(*a, 8), q, k, v, mask)
        one = sp_call(torch, lambda *a: fa.fused_nla_sp(*a, 8, world_one), q, k, v, mask)
        if fa.nla_reduce_kernel.launches != 2 or fa.nla_apply_kernel.launches != 2:
            raise RuntimeError("[par] (a) fused_nla / the world of one did not launch the kernels")
        if not (torch.equal(one[0], k_out) and torch.equal(one[1], k_qs)):
            raise RuntimeError("[par] (a) fused_nla_sp on a world of one is not fused_nla")
        p_out, p_qs, p_grads = sp_call(
            torch, lambda *a: fa.reference_impl(*a, 8), q, k, v, mask)
        single_ms = cuda_ms(torch, lambda: fa.fused_nla(q, k, v, mask, 8), iters=20)
        for coll in ("psum", "ring"):
            got_out = torch.zeros_like(k_out).cpu()
            got_qs = torch.zeros_like(k_qs).cpu()
            got_grads = [torch.zeros_like(g).cpu() for g in k_grads]
            for r in ranks:
                case = r["cases"][f"{kind}/{coll}"]
                rows = slice(case["coords"]["seq"] * 512, (case["coords"]["seq"] + 1) * 512)
                got_out[:, :, rows] = case["out"]
                got_qs[:, rows] = case["qs"]
                for acc, g in zip(got_grads, case["grads"]):
                    acc += g
                sp_launches[0] += case["launches"][0]
                sp_launches[1] += case["launches"][1]
                if case["launches"] != [1, 1]:
                    raise RuntimeError(f"[par] (a) rank launches {case['launches']}, want [1, 1]")
            for ref_name, ref in (("kernel", (k_out, k_qs, k_grads)),
                                  ("plain", (p_out, p_qs, p_grads))):
                pairs = [(got_out, ref[0]), (got_qs, ref[1])] + list(zip(got_grads, ref[2]))
                for got, want in pairs:
                    want = want.cpu()
                    torch.testing.assert_close(got, want, rtol=SP_RTOL, atol=SP_ATOL)
                    worst[ref_name] = max(worst[ref_name], (got - want).abs().max().item())
            log(f"[par] (a) {kind} q [4,1024,256] k/v {list(k.shape)} H=8 {coll}: 2 ranks "
                f"{[r['cases'][f'{kind}/{coll}']['ms'] for r in ranks]} ms a forward (host "
                f"clock, synchronised) beside fused_nla alone {single_ms:.4f} ms (CUDA events)")
    log(f"[par] (a) out, qs and grads wrt q, k, v vs fused_nla: max_abs_err "
        f"{worst['kernel']:.3e}; vs reference_impl: {worst['plain']:.3e} (tolerance rtol "
        f"{SP_RTOL} atol {SP_ATOL}); launches under fused_nla_sp over the ranks: "
        f"reduce {sp_launches[0]} apply {sp_launches[1]}")
    out["sp_launches"] = {"nla_reduce": sp_launches[0], "nla_apply": sp_launches[1]}
    out["sp_max_abs_err"] = worst
    out["mesh_of_one"] = b_vals

    want = np.asarray(b_vals)
    for name in ("data2", "seq2", "model2", "expert3"):
        per_rank = results[name]
        recs = epoch_records(PAR_OUT / name / "m.jsonl")
        got = [r[k] for r in recs for k in keys]
        diff = rel_diff(np, got, want)
        ranks_agree = all(r["losses"] == per_rank[0]["losses"] for r in per_rank)
        secs = [r["epoch_seconds"] for r in recs]
        # Epoch 1's 4 steps, its eval's means over the data ranks included.
        per_step = [(r["allreduce_ms"]["calls"] / 4, round(r["allreduce_ms"]["ms"] / 4, 3))
                    for r in per_rank]
        log(f"[par] (c) {name}: mesh {per_rank[0]['mesh']}; train/test {got}, max rel diff vs "
            f"(b) {diff:.3e} (bar {PAR_RTOL}); ranks' losses equal {ranks_agree}; step time "
            f"{[s / 4 * 1e3 for s in secs]} ms (epoch 0, epoch 1 under the profiler); "
            f"all-reduce a step per rank (calls, ms of gloo's work): {per_step} (epoch 1, "
            f"eval included); "
            f"peak memory {[r['peak_mib'] for r in per_rank]} MiB on {card}")
        if diff > PAR_RTOL or not ranks_agree:
            raise RuntimeError(f"[par] (c) {name} does not train as the mesh of one")

    # The gathered checkpoints are the single-device layout: each evaluates
    # on one device to its run's best metric.
    for name in ("model2", "expert3"):
        argv = [a for a in PAR_ARGV if a != "--distributed"] + [
            "--checkpoint_dir", str(PAR_OUT / f"ck_{name}"), "--eval_only"]
        with contextlib.redirect_stdout(io.StringIO()):
            got = port_main.main(argv)
        want = min(r["test_metric"] for r in epoch_records(PAR_OUT / name / "m.jsonl"))
        log(f"[par] (c) {name}'s best checkpoint (gathered shards) on one device: "
            f"{got} against the run's best {want}")
        if not math.isclose(got, want, rel_tol=PAR_RTOL):
            raise RuntimeError(f"[par] (c) {name}'s checkpoint is not its run's weights")

    stop, res = results["stop"], results["resume"]
    stop_steps = [r["host_step"] for r in stop]
    latest = json.loads((ck / "latest.json").read_text())
    carried = [r["carried"] for r in stop]
    bitwise = all(c["losses"][-1] == r["losses"][-1] and c["metrics"][-1] == r["metrics"][-1]
                  for c, r in zip(carried, res))
    sums = [r["param_sum"] for r in stop + res]
    log(f"[par] (d) SIGTERM to rank 1 alone: stop steps {stop_steps}, latest epoch "
        f"{latest['epoch']} ({latest['dir']}); the resumed run's last epoch bitwise the stopped "
        f"run carried on in memory: {bitwise}, weight sums {sums}; resumed final losses "
        f"{[r['losses'][-1] for r in res]}")
    if set(stop_steps) != {3} or latest["epoch"] != 0 or not bitwise or len(set(sums)) != 1:
        raise RuntimeError("[par] (d) the stop agreement or the resume is not whole")
    log(f"[par] phase 18 took {time.monotonic() - t_phase:.1f} s on {card}")
    return out


# --------------------------------------------------------------------------
# Phase 19: the pipeline schedule, packed batches and the stacked layout on
# a mesh.
# --------------------------------------------------------------------------

PIPE_OUT = TRAIN_OUT / "pipeline"
# Phase 9's packed training flags on the FFN's torch path (a mesh refuses
# the kernel), over the rank mesh.
PACKED_PAR_ARGV = [a if a != "pallas" else "xla" for a in PACKED_TRAIN_ARGV] + ["--distributed"]


def mesh_run_line(np, name: str, per_rank: list, recs: list, want, bubble: float, card: str
                  ) -> float:
    """Log one run of phase 19 (a)-(d) against ``want`` (its epochs' train
    losses and test metrics) and return the max rel diff: per rank the step
    time (epoch seconds over its steps, each epoch), the hops' calls and
    host ms a step (eval's forward hops included) with the share spent
    waiting on gloo, and the peak memory."""
    keys = ("train_loss", "test_metric")
    got = [r[k] for r in recs for k in keys]
    diff = rel_diff(np, got, want)
    steps = per_rank[0]["host_step"] // len(recs)
    hops = [(r["hops"]["calls"] / per_rank[0]["host_step"],
             round(r["hops"]["ms"] / per_rank[0]["host_step"], 3),
             round(r["hops"]["wait_ms"] / max(r["hops"]["ms"], 1e-9), 3)) for r in per_rank]
    agree = all(r["losses"] == per_rank[0]["losses"] for r in per_rank)
    log(f"[pipe] {name}: mesh {per_rank[0]['mesh']}, microbatches {per_rank[0]['micro']}, "
        f"bubble {bubble:.3f}; train/test {got}, max rel diff {diff:.3e} (bar {PAR_RTOL}); "
        f"ranks' losses equal {agree}; step time {[r['epoch_seconds'] / steps * 1e3 for r in recs]}"
        f" ms (epochs 0, 1; rank 0's clock, the card shared by {len(per_rank)} ranks); hops a "
        f"step per rank (calls, host ms, share waiting on gloo): {hops}; peak memory "
        f"{[round(r['peak_mib'], 1) for r in per_rank]} MiB; kernel launches "
        f"{[r['kernel_launches'] for r in per_rank]} on {card}")
    if not agree:
        raise RuntimeError(f"[pipe] {name}: the ranks' losses differ")
    return diff


def pipeline_phase(torch, np, card: str, mesh_of_one: list) -> dict:
    """Phase 19: the rest of parallel training on the one card, ranks as
    processes sharing it through gloo. (a) the pipeline schedule on 2 and
    on 4 ranks, (b) with the model axis, each against phase 18 (b)'s mesh
    of one (``mesh_of_one``); (c) packed rows over the data axis and (d)
    the stacked layout over data x model, each against its single-device
    run; (e) a stop on one rank of a pipe mesh and its bitwise resume.
    Every rank launches no kernel: both packages refuse them on a mesh."""
    from gnot_tpu_torch import main as port_main

    import shutil

    t_phase = time.monotonic()
    shutil.rmtree(PIPE_OUT, ignore_errors=True)
    PIPE_OUT.mkdir(parents=True)
    ck = PIPE_OUT / "ck"
    runs2 = [dict(name="pipe2", argv=PAR_ARGV + ["--mesh_pipe", "2"]),
             dict(name="packed_data2", argv=PACKED_PAR_ARGV + ["--mesh_data", "2"]),
             dict(name="stop", argv=PAR_ARGV + ["--mesh_pipe", "2", "--checkpoint_dir", str(ck)],
                  sigterm_rank=1, carry_on=True)]
    runs4 = [dict(name="pipe4_micro4", argv=PAR_ARGV + ["--mesh_pipe", "4", "--microbatches",
                                                        "4"]),
             dict(name="model2_pipe2", argv=PAR_ARGV + ["--mesh_model", "2", "--mesh_pipe", "2"]),
             dict(name="scan_data2_model2", argv=PAR_ARGV + ["--scan_layers", "--mesh_data", "2",
                                                            "--mesh_model", "2"])]
    resume = [dict(name="resume", argv=PAR_ARGV + ["--mesh_pipe", "2", "--checkpoint_dir",
                                                   str(ck), "--resume"])]
    launches = [(2, dict(runs=runs2)), (4, dict(runs=runs4)), (2, dict(runs=resume))]
    for i, (world, plan) in enumerate(launches):
        for run in plan["runs"]:
            (PIPE_OUT / run["name"]).mkdir()
        (PIPE_OUT / f"plan{i}.json").write_text(json.dumps(plan))
    t0 = time.monotonic()
    # (a)-(d) one launch after another, so that each times its own ranks.
    launch_ranks(2, [str(PIPE_OUT / "plan0.json")], "a, c, e")
    launch_ranks(4, [str(PIPE_OUT / "plan1.json")], "a, b, d")
    # (e)'s resume times nothing: the single-device references beside it.
    port = free_port()
    procs = [popen([sys.executable, str(Path(__file__).resolve()), "--rank",
                    str(PIPE_OUT / "plan2.json")], rank_env(2, port, r)) for r in range(2)]
    try:
        single = {}
        for name, argv in (("packed", PACKED_PAR_ARGV), ("scan", PAR_ARGV + ["--scan_layers"])):
            argv = [a for a in argv if a != "--distributed"]
            with contextlib.redirect_stdout(io.StringIO()):
                port_main.run(argv + ["--metrics_path", str(PIPE_OUT / f"{name}.jsonl")])
            single[name] = [r[k] for r in epoch_records(PIPE_OUT / f"{name}.jsonl")
                            for k in ("train_loss", "test_metric")]
    finally:
        wait_all(procs, "e")
    log(f"[pipe] three launches (a, c, e; a, b, d; e) and the single-device runs "
        f"{time.monotonic() - t0:.1f} s")
    results = par_results(PIPE_OUT, launches)
    out = {"mesh_train_launches": 0}
    worst = 0.0
    for name, want, s, m in (("pipe2", mesh_of_one, 2, 2), ("pipe4_micro4", mesh_of_one, 4, 4),
                             ("model2_pipe2", mesh_of_one, 2, 2),
                             ("packed_data2", single["packed"], 1, 1),
                             ("scan_data2_model2", single["scan"], 1, 1)):
        per_rank = results[name]
        bubble = (s - 1) / (m + s - 1)
        diff = mesh_run_line(np, name, per_rank, epoch_records(PIPE_OUT / name / "m.jsonl"),
                             want, bubble, card)
        out["mesh_train_launches"] += sum(r["kernel_launches"] for r in per_rank)
        if diff > PAR_RTOL:
            raise RuntimeError(f"[pipe] {name} does not train as its reference")
        worst = max(worst, diff)
    if out["mesh_train_launches"]:
        raise RuntimeError(f"[pipe] a mesh launched {out['mesh_train_launches']} kernels")

    stop, res = results["stop"], results["resume"]
    stop_steps = [r["host_step"] for r in stop]
    latest = json.loads((ck / "latest.json").read_text())
    carried = [r["carried"] for r in stop]
    bitwise = all(c["losses"][-1] == r["losses"][-1] and c["metrics"][-1] == r["metrics"][-1]
                  for c, r in zip(carried, res))
    sums = [r["param_sum"] for r in stop + res]
    log(f"[pipe] (e) --mesh_pipe 2, SIGTERM to rank 1 alone: stop steps {stop_steps}, latest "
        f"epoch {latest['epoch']} ({latest['dir']}); the resumed run's last epoch bitwise the "
        f"stopped run carried on in memory: {bitwise}, weight sums {sums}")
    if set(stop_steps) != {3} or latest["epoch"] != 0 or not bitwise or len(set(sums)) != 1:
        raise RuntimeError("[pipe] (e) the stop agreement or the resume is not whole")
    log(f"[pipe] (a)-(d) worst max rel diff {worst:.3e} (bar {PAR_RTOL}); phase 19 took "
        f"{time.monotonic() - t_phase:.1f} s on {card}")
    return out


# --------------------------------------------------------------------------
# Phase 20: the native host packer on the serve and collate path, and the
# port's lint on the card's Python.
# --------------------------------------------------------------------------
# (b): bf16 serving of 32 NS2d-1k requests in 16-row dispatches: a
# dispatch's coords (131,072 B) and input function (98,304 B) cross the
# bf16 bar (96 KB), so each takes the fused pad-and-cast sweep.
NATIVE_SERVE_ARGV = ["--serve", "--serve_dtype", "bfloat16", "--ffn_impl", "pallas",
                     "--synthetic", "ns2d", "--n_test", "32", "--serve_max_batch", "16",
                     "--device", "cuda"]
NATIVE_OUT = TRAIN_OUT / "native20"
# Host timings: median of this many calls, each payload in turns native,
# numpy, numpy, native.
NATIVE_REPS = 7


@contextlib.contextmanager
def native_call_counts(native):
    """Count every call of the packer's C symbols through both dlopen
    handles (``native._lib``, ``native._lib_gil``) by wrapping the handles'
    function objects from here; the package itself counts nothing. Yields
    ``{symbol: calls}``; the handles get their functions back on exit."""
    if not native.native_available():
        raise RuntimeError(f"the native packer did not load: {native.status()['error']}")
    counts = {"gnot_pack_rows": 0, "gnot_pack_rows_bf16": 0, "gnot_unpad_rows": 0}
    saved = []
    for lib in (native._lib, native._lib_gil):
        for name in counts:
            fn = getattr(lib, name)
            saved.append((lib, name, fn))

            def counted(*a, _fn=fn, _name=name):
                counts[_name] += 1
                return _fn(*a)

            setattr(lib, name, counted)
    try:
        yield counts
    finally:
        for lib, name, fn in saved:
            setattr(lib, name, fn)


@contextlib.contextmanager
def packer_bars(native, pack: dict | None = None, unpad: int | None = None):
    """The packer's payload bars set to ``pack`` / ``unpad`` for the block
    (a bar past any payload turns the native path off), restored on exit."""
    saved = dict(native.PACK_NATIVE_MIN_BYTES), native.NATIVE_UNPAD_MIN_BYTES
    if pack is not None:
        native.PACK_NATIVE_MIN_BYTES.update(pack)
    if unpad is not None:
        native.NATIVE_UNPAD_MIN_BYTES = unpad
    try:
        yield
    finally:
        native.PACK_NATIVE_MIN_BYTES.update(saved[0])
        native.NATIVE_UNPAD_MIN_BYTES = saved[1]


def host_ms(fn, reps: int = NATIVE_REPS) -> float:
    """Median host-clock ms of ``reps`` calls of ``fn`` after one warm call."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def crossover_line(tag: str, rows: list[tuple[int, float, float]], bar: int, card: str) -> str:
    """One line of a native-vs-numpy sweep: each payload's two medians and
    the smallest payload from which the native call stays faster."""
    cross = None
    for payload, nat, ref in rows:
        if nat < ref and cross is None:
            cross = payload
        elif nat >= ref:
            cross = None
    parts = ", ".join(f"{p / 2**20:.3f} MiB {n:.4f}/{r:.4f}" for p, n, r in rows)
    found = f"{cross / 2**20:.3f} MiB" if cross is not None else "none in the sweep"
    return (f"[native] {tag} native/numpy host ms (a median of {NATIVE_REPS} calls a turn, "
            f"two turns each in the order native, numpy, numpy, native): {parts}; "
            f"crossover on this host {found} (the JAX package's bar {bar / 2**20:.3f} MiB, "
            f"measured on its own host) on {card}")


def native_direct_calls(np, native, card: str) -> dict:
    """Phase 20 (a): each C symbol above its bar, bitwise its numpy
    version and counted, then the native-vs-numpy sweeps."""
    rng = np.random.default_rng(20)
    # f32 pack: 48 MiB of ragged input, the threaded sweep (32 MB and up).
    arrs = [rng.standard_normal((int(n), 64), dtype=np.float32)
            for n in rng.integers(4000, 4500, size=50)]
    max_len = max(a.shape[0] for a in arrs)
    checks = []
    with native_call_counts(native) as calls:
        out, mask = native.pack_rows(arrs, max_len, "float32")
    want = native.pack_rows_numpy(arrs, max_len, "float32")
    checks.append(("pack_rows f32", sum(a.nbytes for a in arrs), calls["gnot_pack_rows"],
                   np.array_equal(out.view(np.uint32), want[0].view(np.uint32))
                   and np.array_equal(mask, want[1])))
    # bf16 pack: the bf16 serving dispatch's coords, 16 x 1024 x 2 (131 KB).
    arrs16 = [rng.standard_normal((1024, 2), dtype=np.float32) for _ in range(16)]
    arrs16[0][:2] = [[np.nan, -np.nan], [np.inf, -np.inf]]
    with native_call_counts(native) as calls:
        out, mask = native.pack_rows(arrs16, 1024, "bfloat16")
    want = native.pack_rows_numpy(arrs16, 1024, "bfloat16")
    checks.append(("pack_rows bf16", sum(a.nbytes for a in arrs16),
                   calls["gnot_pack_rows_bf16"],
                   np.array_equal(out, want[0]) and np.array_equal(mask, want[1])))
    # unpad: over 8 MiB cut out of a [32, 4200, 16] f32 output, ragged spans.
    dense = rng.standard_normal((32, 4200, 16), dtype=np.float32)
    spans = [(i, int(o), 4200 - int(o)) for i, o in enumerate(rng.integers(0, 64, size=32))]
    with native_call_counts(native) as calls:
        got = native.unpad_rows(dense, spans)
    want = native.unpad_rows_numpy(dense, spans)
    checks.append(("unpad_rows f32", sum(s[2] for s in spans) * 64, calls["gnot_unpad_rows"],
                   all(np.array_equal(g.view(np.uint32), w.view(np.uint32))
                       for g, w in zip(got, want))))
    floors = {"pack_rows f32": 48 << 20, "pack_rows bf16": 96 << 10, "unpad_rows f32": 8 << 20}
    for name, nbytes, n_calls, same in checks:
        if nbytes < floors[name]:
            raise RuntimeError(f"{name}: {nbytes} B is under the phase's {floors[name]} B")
        log(f"[native] {name} at {nbytes / 2**20:.3f} MiB: C symbol calls {n_calls}, "
            f"bitwise the numpy version {same}")
        if n_calls != 1 or not same:
            raise RuntimeError(f"{name}: {n_calls} C calls (want 1), bitwise {same}")

    # The sweeps: each symbol native against numpy at payloads around its
    # bar, in turns native, numpy, numpy, native.
    def sweep(cases, run_native, run_numpy):
        rows = []
        for payload, data in cases:
            nat, ref = [], []
            for which in ("native", "numpy", "numpy", "native"):
                fn = run_native if which == "native" else run_numpy
                (nat if which == "native" else ref).append(host_ms(lambda: fn(data)))
            rows.append((payload, statistics.median(nat), statistics.median(ref)))
        return rows

    lines = []
    bf16_cases = []
    for n_pts in (384, 768, 1536, 3072, 6144, 12288):
        blocks = [rng.standard_normal((n_pts, 2), dtype=np.float32) for _ in range(16)]
        bf16_cases.append((16 * n_pts * 8, blocks))
    with packer_bars(native, pack={"bfloat16": 0}):
        rows = sweep(bf16_cases, lambda b: native.pack_rows(b, b[0].shape[0], "bfloat16"),
                     lambda b: native.pack_rows_numpy(b, b[0].shape[0], "bfloat16"))
    lines.append(crossover_line("pack_rows bf16", rows, native.PACK_NATIVE_MIN_BYTES["bfloat16"],
                                card))
    f32_cases = []
    for mib in (8, 16, 32, 48):
        # mib ragged blocks of about 1 MiB each.
        blocks = [rng.standard_normal((4096 - i, 64), dtype=np.float32) for i in range(mib)]
        f32_cases.append((sum(b.nbytes for b in blocks), blocks))
    with packer_bars(native, pack={"float32": 0}):
        rows = sweep(f32_cases, lambda b: native.pack_rows(b, 4096, "float32"),
                     lambda b: native.pack_rows_numpy(b, 4096, "float32"))
    lines.append(crossover_line("pack_rows f32", rows, native.PACK_NATIVE_MIN_BYTES["float32"],
                                card))
    unpad_cases = []
    for mib in (1, 2, 4, 8, 16):
        length = (mib << 20) // (32 * 16 * 4)
        out = rng.standard_normal((32, length, 16), dtype=np.float32)
        unpad_cases.append((out.nbytes, (out, [(i, 0, length) for i in range(32)])))
    with packer_bars(native, unpad=0):
        rows = sweep(unpad_cases, lambda d: native.unpad_rows(*d),
                     lambda d: native.unpad_rows_numpy(*d))
    lines.append(crossover_line("unpad_rows", rows, native.NATIVE_UNPAD_MIN_BYTES, card))
    for line in lines:
        log(line)
    return {name.replace(" ", "_"): n_calls for name, _, n_calls, _ in checks}


def native_serve_run(torch, port_main, native, argv: list[str], tag: str):
    """One serve run through ``main`` with a sink and run.json under
    NATIVE_OUT/<tag>: (ServeRun, FFN launches, C symbol calls, the
    native_packer records, run.json)."""
    import shutil

    from gnot_tpu_torch.ops.fused_ffn import fused_gated_ffn_kernel

    out = NATIVE_OUT / tag
    shutil.rmtree(out, ignore_errors=True)
    argv = argv + ["--metrics_path", str(out / "m.jsonl")]
    torch.cuda.synchronize()
    fused_gated_ffn_kernel.launches = 0
    fused_gated_ffn_kernel.launches_by_dtype = {}
    with native_call_counts(native) as calls:
        run, _ = run_observed(port_main, argv)
    launches = fused_gated_ffn_kernel.launches
    by_dtype = dict(fused_gated_ffn_kernel.launches_by_dtype)
    records = [r for r in read_jsonl(out / "m.jsonl") if r.get("event") == "native_packer"]
    manifest = json.load(open(out / "run.json"))
    summary = run.summary
    n_ok = sum(r.ok for r in run.results)
    log(f"[native] ({tag}) python -m gnot_tpu_torch.main {' '.join(argv)}: {n_ok}/"
        f"{len(run.results)} ok, dispatches {summary['dispatches']} + "
        f"{summary['warmed_buckets']} warm-up, FFN launches {launches} {json.dumps(by_dtype)}, "
        f"C symbol calls {json.dumps(calls)}, dispatch p50 {summary['dispatch_ms_p50']:.3f} ms "
        f"(host clock)")
    if n_ok != len(run.results):
        raise RuntimeError(f"({tag}) {n_ok}/{len(run.results)} ok: "
                           f"{[(r.reason, r.detail) for r in run.results if not r.ok]}")
    want_status = native.status()
    if (len(records) != 1 or records[0]["impl"] != "native"
            or manifest.get("native_packer") != json.loads(json.dumps(want_status))
            or manifest.get("serve_dtype") != summary["dtype"]):
        raise RuntimeError(f"({tag}) native_packer records {records}, run.json "
                           f"{manifest.get('native_packer')} / {manifest.get('serve_dtype')}")
    dispatches = summary["dispatches"] + summary["warmed_buckets"]
    expected = 2 * run.model.config.n_attn_layers * dispatches
    if launches != expected or set(by_dtype) != {"bf16" if summary["dtype"] == "bfloat16"
                                                 else "f32"}:
        raise RuntimeError(f"({tag}) expected {expected} FFN launches, counted {launches} "
                           f"{by_dtype}")
    return run, launches, dict(calls), dispatches


def native_phase(torch, np, card: str, layers) -> dict:
    """Phase 20: (a) the packer built on this host, each C symbol above its
    bar bitwise its numpy version, and this host's crossovers; (b) bf16
    serving through the fused pad-and-cast against the same run with the
    native path off (bitwise) and the plain-FFN forward (phase 4b's bar),
    with the host dispatch time both ways in turns; (c) f32 serving at
    phase 4's configuration; (d) the port's lint on this Python."""
    from gnot_tpu_torch import main as port_main
    from gnot_tpu_torch import native
    from gnot_tpu_torch.data.batch import collate
    from gnot_tpu_torch.ops.fused_ffn import fused_gated_ffn, fused_gated_ffn_reference
    from gnot_tpu_torch.serve.engine import InferenceEngine

    t_phase = time.monotonic()
    st = native.status()
    log(f"[native] status {json.dumps(st)}")
    if st["impl"] != "native" or not st["available"]:
        raise RuntimeError(f"the native packer did not load: {st['error']}")
    direct = native_direct_calls(np, native, card)

    # (b) bf16 serving, the native path and the numpy path.
    run, launches, calls, dispatches = native_serve_run(
        torch, port_main, native, NATIVE_SERVE_ARGV, "bf16_native")
    bar = native.PACK_NATIVE_MIN_BYTES["bfloat16"]
    s = run.samples[0]
    rows = int(NATIVE_SERVE_ARGV[NATIVE_SERVE_ARGV.index("--serve_max_batch") + 1])
    per_dispatch = sum(rows * a.shape[0] * a.shape[1] * 4 >= bar for a in (s.coords, s.y, *s.funcs))
    if calls["gnot_pack_rows_bf16"] != per_dispatch * dispatches or per_dispatch == 0:
        raise RuntimeError(f"expected {per_dispatch} fused pad-and-cast calls in each of "
                           f"{dispatches} dispatches, counted {calls}")
    log(f"[native] (b) {calls['gnot_pack_rows_bf16']} fused pad-and-cast calls = {per_dispatch} "
        f"fields over the bar x {dispatches} dispatches; FFN launches {launches} = 8 x "
        f"{dispatches}")
    with packer_bars(native, pack={"bfloat16": 1 << 62, "float32": 1 << 62}, unpad=1 << 62):
        off, off_launches, off_calls, _ = native_serve_run(
            torch, port_main, native, NATIVE_SERVE_ARGV, "bf16_numpy")
    if any(off_calls.values()):
        raise RuntimeError(f"the numpy-path run called the C symbols: {off_calls}")
    same = all(np.array_equal(a.output, b.output) for a, b in zip(run.results, off.results))
    log(f"[native] (b) outputs bitwise the numpy-path run's: {same} ({len(run.results)} requests)")
    if not same or len(run.results) != len(off.results):
        raise RuntimeError("bf16 serving through the native packer differs from the numpy path")
    layers.fused_gated_ffn = fused_gated_ffn_reference
    try:
        plain = InferenceEngine(run.model, batch_size=rows, dtype="bfloat16").predict(run.samples)
    finally:
        layers.fused_gated_ffn = fused_gated_ffn
    rel = float(np.linalg.norm(np.concatenate([r.output for r in run.results])
                               - np.concatenate(plain)) / np.linalg.norm(np.concatenate(plain)))
    log(f"[native] (b) outputs vs the same bf16 forward through the kernel's plain version: "
        f"relative norm {rel:.3e} (phase 4b's bar {BF16_PLAIN_REL})")
    if rel > BF16_PLAIN_REL:
        raise RuntimeError(f"bf16 serving off phase 4b's bar: {rel}")
    # The host dispatch: one 16-row bf16 dispatch through the engine, its
    # batch assembly (collate and the copy to the card), device and unpad
    # phases, and collate alone to host tensors, native and numpy in turns
    # after one warm dispatch of each.
    engine = InferenceEngine(run.model, batch_size=rows, dtype="bfloat16")
    group = run.samples[:rows]
    key = engine.bucket_key(group[0])
    big = 1 << 62

    def on_path(which):
        return (packer_bars(native, pack={"bfloat16": big, "float32": big}, unpad=big)
                if which == "numpy" else contextlib.nullcontext())

    def dispatch(timings=None):
        return engine.infer(group, pad_nodes=key[0], pad_funcs=key[1], rows=rows,
                            timings=timings, clock=time.perf_counter)

    for which in ("native", "numpy"):
        with on_path(which):
            dispatch()
    phases = {"native": [], "numpy": []}
    collate_ms = {"native": [], "numpy": []}
    for which in ("native", "numpy", "numpy", "native"):
        with on_path(which):
            collate_ms[which].append(host_ms(lambda: collate(
                group, bucket=False, pad_nodes=key[0], pad_funcs=key[1], device="cpu",
                dtype="bfloat16")))
            for _ in range(NATIVE_REPS):
                t = {}
                t0 = time.perf_counter()
                dispatch(t)
                total = time.perf_counter() - t0
                phases[which].append({k: (v[1] - v[0]) * 1e3 for k, v in t.items()
                                      if isinstance(v, tuple)} | {"total": total * 1e3})
    med = {w: {k: statistics.median(p[k] for p in ps) for k in ps[0]} for w, ps in phases.items()}
    log(f"[native] (b) one 16-row bf16 dispatch, host clock (median of {2 * NATIVE_REPS}, in "
        f"turns native, numpy, numpy, native): batch assembly {med['native']['batch_assembly']:.3f}"
        f" vs {med['numpy']['batch_assembly']:.3f} ms, device (forward + copy to the host) "
        f"{med['native']['device']:.3f} vs {med['numpy']['device']:.3f} ms, unpad "
        f"{med['native']['unpad']:.3f} vs {med['numpy']['unpad']:.3f} ms, whole dispatch "
        f"{med['native']['total']:.3f} vs {med['numpy']['total']:.3f} ms; collate alone to host "
        f"tensors {statistics.median(collate_ms['native']):.3f} vs "
        f"{statistics.median(collate_ms['numpy']):.3f} ms (native vs numpy; bucket {key}, the "
        f"host is the card machine's CPU) on {card}")

    # (c) f32 serving at phase 4's configuration: every payload under the
    # f32 bars, so numpy packs by the policy; the record says native.
    f32_argv = ["--serve", "--ffn_impl", "pallas", "--synthetic", "ns2d", "--n_test", "16",
                "--serve_max_batch", "4", "--device", "cuda"]
    f32_run, f32_launches, f32_calls, _ = native_serve_run(
        torch, port_main, native, f32_argv, "f32")
    if len(f32_run.results) != 16:
        raise RuntimeError(f"(f32) {len(f32_run.results)} results, want 16")
    layers.fused_gated_ffn = fused_gated_ffn_reference
    try:
        plain = InferenceEngine(f32_run.model, batch_size=4).predict(f32_run.samples)
    finally:
        layers.fused_gated_ffn = fused_gated_ffn
    worst = 0.0
    for r, want in zip(f32_run.results, plain):
        np.testing.assert_allclose(r.output, want, rtol=MODEL_RTOL, atol=MODEL_ATOL)
        worst = max(worst, float(np.max(np.abs(r.output - want))))
    log(f"[native] (c) f32: 16/16 ok, {f32_launches} FFN launches, C symbol calls "
        f"{json.dumps(f32_calls)} (every payload under the f32 bars), max_abs_err vs the plain "
        f"forward {worst:.3e} (rtol {MODEL_RTOL} atol {MODEL_ATOL})")

    # (d) the port's lint on this Python.
    t0 = time.monotonic()
    lint = subprocess.run([sys.executable, "-m", "gnot_tpu_torch.analysis"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    last = (lint.stdout.strip().splitlines() or [""])[-1]
    log(f"[native] (d) python -m gnot_tpu_torch.analysis: exit {lint.returncode}, {last} "
        f"({time.monotonic() - t0:.1f} s)")
    if lint.returncode != 0:
        raise RuntimeError(f"the port's lint failed:\n{lint.stdout}\n{lint.stderr}")
    log(f"[native] phase 20 took {time.monotonic() - t_phase:.1f} s")
    return {"native_serve_launches": launches, "native_serve_numpy_launches": off_launches,
            "native_serve_f32_launches": f32_launches, "native_direct_calls": direct}


# --------------------------------------------------------------------------
# Phase 21: serving over a rank mesh, parity mode on the seq and model axes,
# and the port's diff-scoped lint.
# --------------------------------------------------------------------------
MESH_OUT = TRAIN_OUT / "mesh21"
# (a): phase 4's traffic (16 NS2d-1k requests, max_batch 4) through the
# FFN's torch path, which both packages take on a mesh.
MESH_SERVE_ARGV = ["--serve", "--ffn_impl", "xla", "--synthetic", "ns2d", "--n_train", "16",
                   "--n_test", "16", "--serve_max_batch", "4", "--device", "cuda"]
# (c): phase 7's flags (darcy2d, 256 points: the pads are the same bucketed
# or not) through the FFN's torch path.
MESH_PARITY_ARGV = [a if a != "pallas" else "xla" for a in PARITY_ARGV]
# (b): the first words of JAX's refusals (gnot_tpu/main.py:1093-1098 and
# :1110-1115), which the port raises word for word (its CPU tests compare
# them with JAX's own).
MESH_REFUSALS = {"two nodes": "--serve is single-process (the request-serving layer",
                 "replicas": "--serve_replicas/--autoscale build their own per-replica",
                 "autoscale": "--serve_replicas/--autoscale build their own per-replica"}


def mesh_outputs(np, name: str) -> list:
    outs = np.load(MESH_OUT / name / "outputs.npz")
    return [outs[f"arr_{i}"] for i in range(len(outs.files))]


def mesh_serving_phase(torch, np, card: str) -> dict:
    """Phase 21: (b) first, in this process, the refusals of ``--serve
    --distributed`` before any rank exists; the single-device references;
    then one launch of 2 ranks sharing the card (gloo with CUDA tensors):
    (a) serving on ``--mesh_data 2``, ``--mesh_model 2`` and ``--mesh_seq 2``
    against the single-device ``--serve --ffn_impl xla`` run, bf16 on the
    data mesh, a hot reload mid-stream on it, and a SIGTERM to rank 0; (c)
    parity training on ``--mesh_model 2`` and ``--mesh_seq 2`` against the
    single-device parity runs; then (d) the lint's ``--changed`` mode.
    Every rank launches no kernel: both packages refuse them on a mesh."""
    from gnot_tpu_torch import main as port_main
    from gnot_tpu_torch.parallel import multihost
    from gnot_tpu_torch.serve.engine import InferenceEngine
    from gnot_tpu_torch.train.checkpoint import Checkpointer
    from gnot_tpu_torch.train.trainer import Trainer

    import shutil

    t_phase = time.monotonic()
    shutil.rmtree(MESH_OUT, ignore_errors=True)
    MESH_OUT.mkdir(parents=True)

    # (b) JAX's refusals, raised before any rank would wait on another.
    base = MESH_SERVE_ARGV + ["--distributed"]
    node_count = multihost.node_count
    for tag, flags in (("two nodes", []), ("replicas", ["--serve_replicas", "2"]),
                       ("autoscale", ["--autoscale"])):
        if tag == "two nodes":
            multihost.node_count = lambda: 2
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                port_main.run(base + flags)
        except ValueError as exc:
            message = str(exc)
        else:
            raise RuntimeError(f"[mesh] (b) {tag}: --serve --distributed was not refused")
        finally:
            multihost.node_count = node_count
        log(f"[mesh] (b) {tag}: ValueError {message!r}")
        if not message.startswith(MESH_REFUSALS[tag]):
            raise RuntimeError(f"[mesh] (b) {tag}: not JAX's words")

    # The references on one device: the seed's weights (A) served plainly,
    # a checkpoint holding A as best and A * 0.9 (B) as latest, B's outputs
    # through the engine at the served shape, and the parity runs.
    t0 = time.monotonic()
    ck = MESH_OUT / "ck"
    args = port_main.build_parser().parse_args(MESH_SERVE_ARGV)
    from gnot_tpu_torch.data import datasets

    train, test = datasets.load(port_main.data_config(args))
    mc = port_main.model_config(args, train)
    trainer = Trainer(port_main.train_config(args), mc, train, test, device="cuda")
    trainer.initialize()
    saver = Checkpointer(str(ck), extra_meta=port_main.checkpoint_meta(args, mc))
    saver.save_best(trainer.checkpoint_state(), 0, 1.0)
    with torch.no_grad():
        for p in trainer.model.parameters():
            p.mul_(0.9)
    saver.save_latest(trainer.checkpoint_state(), 1, 2.0)
    saver.wait()
    with contextlib.redirect_stdout(io.StringIO()):
        single = port_main.run(MESH_SERVE_ARGV)
    want = [r.output for r in single.results]
    engine_b = InferenceEngine(trainer.model, batch_size=4)
    pn, pf = engine_b.bucket_key(single.samples[0])
    want_b = [o for i in range(0, 16, 4)
              for o in engine_b.infer(single.samples[i:i + 4], pad_nodes=pn, pad_funcs=pf)]
    del trainer, engine_b
    parity_want = {}
    data_config = port_main.data_config
    for tag, bucketed in (("", False), ("bucketed", True)):
        path = MESH_OUT / f"parity_single{tag}.jsonl"
        if bucketed:
            port_main.data_config = lambda a: dataclasses.replace(data_config(a), bucket=True)
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                port_main.run(MESH_PARITY_ARGV + ["--metrics_path", str(path)])
        finally:
            port_main.data_config = data_config
        parity_want[bucketed] = [r[k] for r in epoch_records(path)
                                 for k in ("train_loss", "test_metric")]
    log(f"[mesh] single-device references (the f32 serve run, B's outputs, two parity runs) "
        f"{time.monotonic() - t0:.1f} s; parity bucketed vs not: "
        f"{rel_diff(np, parity_want[True], parity_want[False]):.3e} (darcy2d's 256-point pads)")

    # (a) and (c): one launch of 2 ranks sharing the card.
    def serve(name, *flags, **kw):
        return dict(name=name, argv=base + list(flags), **kw)

    runs = [serve("serve_data2", "--mesh_data", "2"),
            serve("serve_model2", "--mesh_model", "2"),
            serve("serve_seq2", "--mesh_seq", "2"),
            serve("serve_bf16_data2", "--mesh_data", "2", "--serve_dtype", "bfloat16"),
            serve("serve_reload_data2", "--mesh_data", "2", "--checkpoint_dir", str(ck),
                  "--serve_reload_every", "8"),
            serve("serve_sigterm_data2", "--mesh_data", "2", sigterm_submit=3),
            dict(name="parity_model2", argv=MESH_PARITY_ARGV + ["--distributed", "--mesh_model",
                                                                "2"]),
            dict(name="parity_seq2", argv=MESH_PARITY_ARGV + ["--distributed", "--mesh_seq", "2"],
                 bucketed=True)]
    launches = [(2, dict(runs=runs))]
    for run in runs:
        (MESH_OUT / run["name"]).mkdir()
    (MESH_OUT / "plan0.json").write_text(json.dumps(launches[0][1]))
    t0 = time.monotonic()
    launch_ranks(2, [str(MESH_OUT / "plan0.json")], "mesh serving and parity")
    log(f"[mesh] one launch of 2 ranks, {len(runs)} runs: {time.monotonic() - t0:.1f} s")
    results = par_results(MESH_OUT, launches)
    out = {"mesh_serve_launches": 0, "mesh_parity_train_launches": 0}

    for run in runs[:6]:
        name = run["name"]
        lead, follower = results[name]
        out["mesh_serve_launches"] += lead["kernel_launches"] + follower["kernel_launches"]
        summary, stats, fol = lead["summary"], lead["summary"]["mesh"], follower["follower"]
        got = mesh_outputs(np, name)
        n = summary["requests"]
        if lead["ok"] != [True] * n or summary["completed"] != n:
            raise RuntimeError(f"[mesh] (a) {name}: {summary['completed']}/{n} ok")
        if fol["dispatches"] != stats["dispatches"] or fol["weights"] != stats["weights"]:
            raise RuntimeError(f"[mesh] (a) {name}: the follower ran {fol}, rank 0 {stats}")
        if name == "serve_bf16_data2":
            worst = max(float(np.linalg.norm(g - w) / np.linalg.norm(w))
                        for g, w in zip(got, want))
            verdict = f"worst relative norm vs the f32 single-device run {worst:.3e} (bar " \
                      f"{BF16_F32_REL})"
            if worst > BF16_F32_REL:
                raise RuntimeError(f"[mesh] (a) {name}: {verdict}")
        elif name == "serve_reload_data2":
            # Reloads after the 8th and the 16th submission, both to B.
            if summary["reloads"] != 2:
                raise RuntimeError(f"[mesh] (a) {name}: {summary['reloads']} reloads")
            after = max(float(np.max(np.abs(g - w))) for g, w in zip(got[8:], want_b[8:]))
            for g, w in zip(got[8:], want_b[8:]):
                np.testing.assert_allclose(g, w, rtol=MODEL_RTOL, atol=MODEL_ATOL)
            before = ["A" if np.allclose(g, a, rtol=MODEL_RTOL, atol=MODEL_ATOL) else
                      "B" if np.allclose(g, b, rtol=MODEL_RTOL, atol=MODEL_ATOL) else "?"
                      for g, a, b in zip(got[:8], want[:8], want_b[:8])]
            if "?" in before:
                raise RuntimeError(f"[mesh] (a) {name}: requests 1-8 served {before}")
            verdict = (f"{summary['reloads']} reloads; requests 1-8 on weights "
                       f"{''.join(before)}, 9-16 on B within "
                       f"max_abs_err {after:.3e} of B's single-device outputs; restores "
                       f"{lead['console'].count('Restored')}")
        else:
            worst = 0.0
            for g, w in zip(got, want[:n]):
                np.testing.assert_allclose(g, w, rtol=MODEL_RTOL, atol=MODEL_ATOL)
                worst = max(worst, float(np.max(np.abs(g - w))))
            verdict = f"max_abs_err vs the single-device run {worst:.3e}"
            if name == "serve_sigterm_data2":
                if n != 3:
                    raise RuntimeError(f"[mesh] (a) {name}: {n} requests after the SIGTERM")
                verdict += "; SIGTERM at the 3rd submit: rank 0 drained, both ranks exit 0"
        log(f"[mesh] (a) {name}: {summary['completed']}/{n} ok, mesh {stats['shape']}, "
            f"{stats['dispatches']} dispatches ({summary['dispatches']} served + warm-up), "
            f"{stats['weights']} weight ops ({stats['weights_ms']:.1f} ms on rank 0); a dispatch "
            f"p50 {summary['dispatch_ms_p50']:.2f} ms host clock; medians after the first "
            f"dispatch on rank 0: broadcast {stats['broadcast_ms_p50']:.3f} ms, forward "
            f"{stats['forward_ms_p50']:.2f} ms, gather {stats['gather_ms_p50']:.3f} ms; the "
            f"follower's receive {fol['broadcast_ms_p50']:.2f} ms (its idle wait included), "
            f"forward {fol['forward_ms_p50']:.2f} ms; FFN launches {lead['kernel_launches']} + "
            f"{follower['kernel_launches']}; peak {lead['peak_mib']:.0f} / "
            f"{follower['peak_mib']:.0f} MiB; {verdict}")

    for name, bucketed in (("parity_model2", False), ("parity_seq2", True)):
        per_rank = results[name]
        out["mesh_parity_train_launches"] += sum(r["kernel_launches"] for r in per_rank)
        recs = epoch_records(MESH_OUT / name / "m.jsonl")
        got = [r[k] for r in recs for k in ("train_loss", "test_metric")]
        diff = rel_diff(np, got, parity_want[bucketed])
        steps = per_rank[0]["host_step"] // len(recs)
        agree = all(r["losses"] == per_rank[0]["losses"] for r in per_rank)
        calls = [r["gathers"]["calls"] for r in per_rank]
        log(f"[mesh] (c) {name}: mesh {per_rank[0]['mesh']}; train/test {got}, max rel diff vs "
            f"the single-device parity run {diff:.3e} (bar {PAR_RTOL}); ranks' losses equal "
            f"{agree}; step time {[r['epoch_seconds'] / steps * 1e3 for r in recs]} ms (epochs "
            f"0, 1, eval included); the merge's all-gathers per rank {calls} over "
            f"{per_rank[0]['host_step']} steps and the evals, "
            f"{[round(r['gathers']['ms'] / per_rank[0]['host_step'], 2) for r in per_rank]} "
            f"host ms a step; peak {[round(r['peak_mib']) for r in per_rank]} MiB; FFN launches "
            f"{[r['kernel_launches'] for r in per_rank]} on {card}")
        if diff > PAR_RTOL or not agree or min(calls) == 0:
            raise RuntimeError(f"[mesh] (c) {name} does not train as the single-device run")
    if out["mesh_serve_launches"] or out["mesh_parity_train_launches"]:
        raise RuntimeError(f"[mesh] a mesh launched kernels: {out}")

    # (d) the lint scoped to what git sees changed (the full run without git).
    t0 = time.monotonic()
    lint = subprocess.run([sys.executable, "-m", "gnot_tpu_torch.analysis", "--changed"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    last = (lint.stdout.strip().splitlines() or [""])[-1]
    note = (lint.stderr.strip().splitlines() or [""])[-1]
    log(f"[mesh] (d) python -m gnot_tpu_torch.analysis --changed: exit {lint.returncode}, "
        f"{last} {note} ({time.monotonic() - t0:.1f} s)")
    if lint.returncode != 0:
        raise RuntimeError(f"the port's --changed lint failed:\n{lint.stdout}\n{lint.stderr}")
    log(f"[mesh] phase 21 took {time.monotonic() - t_phase:.1f} s on {card}")
    return out


# --------------------------------------------------------------------------
# Phase 22: the serving operator's tools on the card host.
# --------------------------------------------------------------------------
TOOLS_OUT = TRAIN_OUT / "tools22"
# (a): phase 4's serving (the reference-default model, 16 NS2d-1k requests,
# max_batch 4) with the trace, the event sink and the live metrics plane;
# the paths are appended per run.
TOOLS_SERVE_ARGV = SERVE13_ARGV + ["--metrics_interval_s", "0.05"]
# (c): the smoke's modes on the card; the metrics path is appended per run
# (and the trace path to "trace").
SMOKE22_MODES = {
    "default": [],
    "replicas": ["--replicas", "2", "--inject_fault", "none"],
    "rollout": ["--n", "6", "--rollout", "3", "--replicas", "2"],
    "tenants": ["--tenants", "--n", "24"],
    "hosts": ["--n", "8", "--hosts", "2", "--replicas", "2", "--inject_fault", "none"],
    "capacity": ["--n", "6", "--mesh_lo", "80", "--mesh_hi", "200", "--inject_fault", "none",
                 "--deadline_ms", "10000", "--capacity"],
    "trace": ["--n", "8"],
}
# Runs `python -m <module> <args>` (or `-c <code> <args>`) in a process where
# every import of JAX, flax or the JAX package raises; its last stderr line
# names the imports it refused and the ones loaded anyway (both must be []).
NO_JAX = r"""
import runpy, sys, time
BLOCKED = ("jax", "jaxlib", "flax", "gnot_tpu")
refused = []
class NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            refused.append(name)
            raise ImportError(f"import of {name} refused: this process runs without JAX")
        return None
sys.meta_path.insert(0, NoJax())
target, sys.argv = sys.argv[1], sys.argv[1:]
code, t0 = 0, time.perf_counter()
try:
    if target == "-c":
        source, sys.argv = sys.argv[1], ["-c"] + sys.argv[2:]
        exec(compile(source, "<no-jax>", "exec"), {"__name__": "__main__"})
    else:
        runpy.run_module(target, run_name="__main__", alter_sys=True)
except SystemExit as e:
    code = e.code or 0
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print(f"no-jax: refused {refused} loaded {loaded} in {(time.perf_counter() - t0) * 1e3:.1f} ms",
      file=sys.stderr)
sys.exit(code)
"""
# The capacity fold of a run's serve_summary event (capacity_report's pure
# parts), run under NO_JAX: one JSON line.
CAPACITY_FOLD = r"""
import json, sys
from gnot_tpu_torch.tools import capacity_report as cr
events = [json.loads(line) for line in open(sys.argv[1]) if line.strip()]
[summary] = [e for e in events if e.get("event") == "serve_summary"]
model = summary["capacity_model"]
print(json.dumps({"programs": cr.program_rows(model), "capacity": cr.capacity_row(summary, model),
                  "pack": cr.pack_recommendation(model, 64, 4, None)}))
"""


def no_jax_run(*args: str) -> tuple[subprocess.CompletedProcess, float]:
    """``NO_JAX`` with ``args`` from the checkout's root: the finished
    process and its wall seconds. Fails unless it exits 0 having refused
    and loaded nothing of JAX."""
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", NO_JAX, *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    wall = time.monotonic() - t0
    note = (proc.stderr.strip().splitlines() or [""])[-1]
    if proc.returncode != 0 or not note.startswith("no-jax: refused [] loaded []"):
        raise RuntimeError(f"[tools] {args[0]} without JAX: exit {proc.returncode}\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return proc, wall


def tools_phase(torch, np, card: str, layers) -> dict:
    """Phase 22: (a) phase 4's serving through ``main --serve --ffn_impl
    pallas`` with ``--trace_path``, ``--metrics_path`` and
    ``--metrics_interval_s`` and a program catalog on the server, held to
    phase 4's bars; (b) the port's readers on (a)'s files in processes
    where JAX cannot be imported: ``trace_report``, ``metrics_report`` and
    the capacity fold; (c) ``serve_smoke`` on the card in its default mode
    and with ``--replicas 2``, ``--rollout``, ``--tenants``, ``--hosts 2``,
    ``--capacity`` and ``--trace_path``; (d) each reader's host ms and each
    smoke mode's wall time. Returns the FFN kernel's launches over (a)."""
    import shutil

    from gnot_tpu_torch import main as port_main
    from gnot_tpu_torch.ops.fused_ffn import fused_gated_ffn_kernel
    from gnot_tpu_torch.serve.catalog import ProgramCatalog
    from gnot_tpu_torch.tools import capacity_report, metrics_report, serve_smoke, trace_report

    shutil.rmtree(TOOLS_OUT, ignore_errors=True)
    TOOLS_OUT.mkdir(parents=True)
    t_phase = time.monotonic()

    # (a) Full-width serving that writes the readers' files. main attaches
    # no catalog; the server gets one on the run's sink, as phase 16's do.
    d = TOOLS_OUT / "serve"
    argv = TOOLS_SERVE_ARGV + ["--metrics_path", str(d / "m.jsonl"),
                               "--trace_path", str(d / "t.json")]
    server_cls = port_main.InferenceServer

    def with_catalog(engine, **kw):
        return server_cls(engine, catalog=ProgramCatalog(sink=kw.get("sink")), **kw)

    port_main.InferenceServer = with_catalog
    try:
        fused_gated_ffn_kernel.launches = 0
        t0 = time.monotonic()
        run, lines = run_observed(port_main, argv)
        serve_s = time.monotonic() - t0
        launches = fused_gated_ffn_kernel.launches
    finally:
        port_main.InferenceServer = server_cls
    summary = run.summary
    per_forward = 2 * run.model.config.n_attn_layers
    dispatches = summary["dispatches"] + summary["warmed_buckets"]
    worst = hold_to_plain(np, "tools a", run.results, plain_outputs(torch, layers, run.model,
                                                                     run.samples))
    log(f"[tools] (a) python -m gnot_tpu_torch.main {' '.join(argv)} (a ProgramCatalog on the "
        f"server): {sum(r.ok for r in run.results)}/{len(run.results)} ok in {serve_s:.2f} s, "
        f"{[line for line in lines if line.startswith(('Wrote ', 'Metrics plane'))]}; outputs "
        f"vs the plain-FFN forward max_abs_err {worst:.3e} (rtol {MODEL_RTOL} atol "
        f"{MODEL_ATOL}); fused_gated_ffn launches {launches} = {per_forward} x {dispatches} "
        f"dispatches ({summary['dispatches']} served + {summary['warmed_buckets']} warm-up)")
    if (len(run.results) != 16 or not all(r.ok for r in run.results)
            or launches != per_forward * dispatches or not summary.get("capacity_model")
            or (run.metrics or {}).get("summary_agrees") is not True):
        raise RuntimeError(f"[tools] (a) the served run is not whole: {json.dumps(summary)}")

    # (b) The readers on (a)'s files, without JAX.
    trace, series, metrics = d / "t.json", d / "m.series.jsonl", d / "m.jsonl"
    proc, trace_wall = no_jax_run("gnot_tpu_torch.tools.trace_report", str(trace), "--json")
    rep = json.loads(proc.stdout)
    kinds = rep["kinds"]
    cp = rep["critical_path"]
    log(f"[tools] (b) trace_report {trace.relative_to(ROOT)} (no JAX, {trace_wall:.2f} s wall): "
        f"{rep['spans']} spans, queue_wait {kinds['queue_wait']['count']} (p50 "
        f"{kinds['queue_wait']['p50_ms']} p99 {kinds['queue_wait']['p99_ms']} ms), device "
        f"{kinds['device']['count']} (p50 {kinds['device']['p50_ms']} p99 "
        f"{kinds['device']['p99_ms']} ms), buckets {rep['buckets']}; critical path "
        f"{cp and (cp['kind'], cp['trace_id'], cp['total_ms'], [p['name'] for p in cp['phases']])}")
    if (kinds["queue_wait"]["count"] != 16 or kinds["device"]["count"] != 16
            or not cp or cp["kind"] != "request"):
        raise RuntimeError(f"[tools] (b) trace_report does not read the run: {rep}")
    proc, metrics_wall = no_jax_run("gnot_tpu_torch.tools.metrics_report", str(series),
                                    "--metrics", str(metrics))
    agree = [line for line in proc.stdout.splitlines() if "agrees with serve_summary" in line]
    log(f"[tools] (b) metrics_report {series.relative_to(ROOT)} (no JAX, {metrics_wall:.2f} s "
        f"wall): exit 0, {proc.stdout.splitlines()[0]}; {agree}")
    if not agree:
        raise RuntimeError(f"[tools] (b) metrics_report: no final-snapshot agreement\n{proc.stdout}")
    proc, fold_wall = no_jax_run("-c", CAPACITY_FOLD, str(metrics))
    fold = json.loads(proc.stdout)
    cap, pack = fold["capacity"], fold["pack"]
    log(f"[tools] (b) capacity fold of the serve_summary event (no JAX, {fold_wall:.2f} s "
        f"wall): programs {[(r['program'], r['dispatches'], r['flops_per_s']) for r in fold['programs']]}; "
        f"agreement {cap['agreement']}; sustainable {cap['sustainable_requests_per_s']} "
        f"requests/s, {cap['sustainable_tokens_per_s']} tokens/s; pack plan {pack['plan']}, "
        f"projected pad waste {pack['projected_pad_waste']} vs observed "
        f"{pack['observed_pad_waste']} ({card})")
    if cap["agreement"]["problems"] != [] or not fold["programs"]:
        raise RuntimeError(f"[tools] (b) the capacity fold disagrees: {cap['agreement']}")

    # (d, readers) each reader in this process, host clock, on (a)'s files.
    events_ = read_jsonl(metrics)
    [event] = [e for e in events_ if e.get("event") == "serve_summary"]
    model = event["capacity_model"]
    reader_ms = {}
    for name, fn in (
        ("trace_report.report", lambda: trace_report.report(str(trace))),
        ("metrics_report.run", lambda: metrics_report.run([str(series), "--metrics", str(metrics)])),
        ("capacity fold", lambda: (capacity_report.program_rows(model),
                                   capacity_report.capacity_row(event, model),
                                   capacity_report.pack_recommendation(model, 64, 4, None))),
    ):
        times = []
        for _ in range(5):
            with contextlib.redirect_stdout(io.StringIO()):
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
        reader_ms[name] = statistics.median(times)
    log(f"[tools] (d) reader host ms (median of 5, this process): "
        f"{ {k: round(v, 3) for k, v in reader_ms.items()} }; without-JAX processes' wall "
        f"{trace_wall:.2f} / {metrics_wall:.2f} / {fold_wall:.2f} s (interpreter and torch "
        f"import included); on {card}")

    # (c) The smoke's modes on the card.
    walls = {}
    for mode, flags in SMOKE22_MODES.items():
        md = TOOLS_OUT / "smoke" / mode
        md.mkdir(parents=True)
        smoke_argv = flags + ["--metrics_path", str(md / "serve.jsonl")]
        if mode == "trace":
            smoke_argv += ["--trace_path", str(md / "trace.json")]
        t0 = time.monotonic()
        got = serve_smoke.run(smoke_argv)
        walls[mode] = time.monotonic() - t0
        log(f"[tools] (c) serve_smoke {' '.join(smoke_argv)}: failures {got['failures']}, "
            f"{walls[mode]:.2f} s wall, storm {got['wall_s']:.3f} s, "
            f"{got['requests_per_s']:.1f} requests/s")
        if got["failures"]:
            raise RuntimeError(f"[tools] (c) serve_smoke {mode} failed: {got['failures']}")
    log(f"[tools] (d) smoke wall s {json.dumps({k: round(v, 3) for k, v in walls.items()})} on "
        f"{card}")
    log(f"[tools] phase 22 took {time.monotonic() - t_phase:.1f} s on {card}")
    return {"readers_serve_launches": launches}


# -- phase 23: training at the reference's scale and at long context -----------------

REF_OUT = TRAIN_OUT / "ref_scale23"
# (b): the tool's pickles through main with the FFN kernel (the pickle paths
# come first).
REF_TRAIN_FLAGS = ["--dtype", "bfloat16", "--steps_per_dispatch", "5", "--epochs", "2",
                   "--ffn_impl", "pallas", "--device", "cuda"]
# (c): heatsink3d at long context, one run per (synth_size, batch_size).
LONG_RUNS = ((16384, 2), (65536, 1))
LONG_FLAGS = ["--synthetic", "heatsink3d", "--remat", "--dtype", "bfloat16", "--ffn_impl",
              "pallas", "--n_train", "4", "--n_test", "2", "--epochs", "1", "--device", "cuda"]
# (e): the FFN kernel's launch shapes [B, L] (width 256) of (b) and (c).
REF_SHAPES = ((4, 12288), (2, 24576), (1, 98304))
# The summary record of tools/reference_scale_demo.py, by its keys.
REF_SUMMARY_KEYS = {"kind", "n_train", "epochs", "best_metric", "wall_seconds",
                    "train_points_per_sec_end_to_end"}


@contextlib.contextmanager
def ffn_launch_shapes(layers):
    """Every FFN call the model sends to the kernel, as (x shape, x dtype,
    weight dtype), recorded around ``layers.fused_gated_ffn``."""
    seen: list = []
    real = layers.fused_gated_ffn

    def recording(x, scores, kernels, biases, gelu_kind):
        seen.append((tuple(x.shape), str(x.dtype).removeprefix("torch."),
                     str(kernels[0].dtype).removeprefix("torch.")))
        return real(x, scores, kernels, biases, gelu_kind=gelu_kind)

    layers.fused_gated_ffn = recording
    try:
        yield seen
    finally:
        layers.fused_gated_ffn = real


def loader_shapes(trainer) -> set:
    """The ``[B, L]`` of every batch of the run's first train epoch and of
    its test loader: the launch shapes the run gives the FFN kernel."""
    trainer.train_loader.set_epoch(0)
    shapes = {tuple(b.coords.shape[:2]) for b in trainer.train_loader}
    return shapes | {tuple(b.coords.shape[:2]) for b in trainer.test_loader}


def ffn_blocks(rows: int, n_sm: int) -> tuple[int, float]:
    """The FFN kernel's CTAs for ``rows`` token rows (a cluster of two a
    64-row tile, csrc/fused_gated_ffn.cu) and the waves they make on
    ``n_sm`` SMs at one CTA an SM."""
    blocks = 2 * -(-rows // 64)
    return blocks, blocks / n_sm


def live_mix_check(torch, np, layers, model, shape: tuple, tag: str) -> float:
    """The FFN kernel against its plain version on the live weights of every
    FFN module of ``model``, at launch shape ``shape`` in the training mix
    (bf16 x, the f32 weights, f32 scores): within one bf16 ulp. Returns the
    worst absolute difference."""
    from gnot_tpu_torch.ops.fused_ffn import fused_gated_ffn_kernel, fused_gated_ffn_reference

    ffns = [m for m in model.modules() if isinstance(m, layers.GatedExpertFfn)]
    rng = np.random.default_rng(23)
    b, l, width = shape
    x = torch.from_numpy(rng.standard_normal((b, l, width), dtype=np.float32)).cuda().bfloat16()
    n_expert = ffns[0].experts.layers()[0].kernel.shape[0]
    logits = torch.from_numpy(rng.standard_normal((b, l, n_expert), dtype=np.float32)).cuda()
    scores = torch.softmax(logits, -1)
    worst = 0.0
    with torch.inference_mode():
        for f in ffns:
            k = [lin.kernel for lin in f.experts.layers()]
            bias = [lin.bias for lin in f.experts.layers()]
            got = fused_gated_ffn_kernel(x, scores, k, bias, gelu_kind=f.gelu)
            want = fused_gated_ffn_reference(x, scores, k, bias, gelu_kind=f.gelu)
            torch.testing.assert_close(got.float(), want.float(), rtol=BF16_RTOL, atol=BF16_ATOL)
            worst = max(worst, (got.float() - want.float()).abs().max().item())
            del got, want
    log(f"[{tag}] kernel vs plain on the live weights of all {len(ffns)} FFN modules at "
        f"x {list(shape)} bf16 (the run's launch shape): max_abs_err {worst:.3e} (one bf16 ulp: "
        f"rtol {BF16_RTOL} atol {BF16_ATOL})")
    return worst


def reference_scale_phase(torch, np, card: str, layers, attn: dict, mix: dict) -> dict:
    """Phase 23: (a) the reference-scale tool at a cut scale with JAX's
    argv; (b) its pickles through main with the FFN kernel, held against the
    plain-FFN run; (c) heatsink3d at L = 16k and 64k with remat; (d) the
    four attention kernels on bf16 inputs at full width; (e) device time
    against the bound at the new shapes. Returns the kernels line's fields:
    ``ffn`` for the FFN kernel's entry, ``attn`` by attention kernel."""
    import argparse
    import shutil

    from gnot_tpu_torch import main as port_main
    from gnot_tpu_torch import validate_kernels as vk
    from gnot_tpu_torch.ops import fused_attention as fa
    from gnot_tpu_torch.ops.fused_ffn import (
        fused_gated_ffn,
        fused_gated_ffn_kernel,
        fused_gated_ffn_reference,
    )
    from gnot_tpu_torch.tools import reference_scale_demo as demo
    from gnot_tpu_torch.train.trainer import Trainer, batch_loss

    t_phase = time.monotonic()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    shutil.rmtree(REF_OUT, ignore_errors=True)
    out: dict = {}

    # (a) The tool at a cut scale: 16 / 4 reference-scale samples, JAX's
    # argv (ffn_impl xla: no FFN kernel launch), 2 epochs, on the card.
    saved = demo.TRAIN_PKL, demo.TEST_PKL, demo.METRICS
    demo.TRAIN_PKL, demo.TEST_PKL = str(REF_OUT / "train.pkl"), str(REF_OUT / "test.pkl")
    demo.METRICS = str(REF_OUT / "demo_metrics.jsonl")
    try:
        t0 = time.monotonic()
        with contextlib.redirect_stdout(io.StringIO()) as gen_out:
            demo.generate(16, 4)
        gen_s = time.monotonic() - t0
        fused_gated_ffn_kernel.launches = 0
        demo_args = argparse.Namespace(epochs=2, steps_per_dispatch=5, device="cuda",
                                       out=str(REF_OUT / "demo.jsonl"))
        held_mib = reset_peak(torch)
        with contextlib.redirect_stdout(io.StringIO()) as train_out:
            demo.train(demo_args)
        demo_mib = torch.cuda.max_memory_allocated() / 2**20 - held_mib
        demo_launches = fused_gated_ffn_kernel.launches
    finally:
        train_pkl, test_pkl = demo.TRAIN_PKL, demo.TEST_PKL
        demo.TRAIN_PKL, demo.TEST_PKL, demo.METRICS = saved
    for line in gen_out.getvalue().splitlines() + train_out.getvalue().splitlines():
        if line:
            log(f"[ref23] (a)   {line}")
    records = read_jsonl(demo_args.out)
    [summary] = [r for r in records if r.get("kind") == "summary"]
    epochs = [r for r in records if "train_loss" in r]
    log(f"[ref23] (a) python -m gnot_tpu_torch.tools.reference_scale_demo --generate --train "
        f"--n_train 16 --n_test 4 --epochs 2 (pickles under {REF_OUT.relative_to(ROOT)}): "
        f"generate {gen_s:.1f} s; summary {json.dumps(summary)}; epochs' points_per_sec "
        f"{[round(r['points_per_sec'], 1) for r in epochs]}, epoch_seconds "
        f"{[round(r['epoch_seconds'], 3) for r in epochs]}; FFN kernel launches {demo_launches} "
        f"(JAX's argv trains ffn_impl=xla); the run's own peak device memory {demo_mib:.1f} MiB "
        f"on {card}")
    if (set(summary) != REF_SUMMARY_KEYS or summary["n_train"] != 16 or len(epochs) != 2
            or not all(math.isfinite(r["train_loss"]) for r in epochs) or demo_launches
            or not math.isfinite(summary["best_metric"])):
        raise RuntimeError(f"[ref23] (a) the tool's run is not JAX's: {summary}, {epochs}, "
                           f"{demo_launches} launches")
    out["ref_scale_demo_launches"] = demo_launches

    # (b) The same pickles through main with the FFN kernel, held against
    # the plain-FFN run step by step.
    argv = ["--train_data", train_pkl, "--test_data", test_pkl] + REF_TRAIN_FLAGS
    args = port_main.build_parser().parse_args(argv)
    held_mib = reset_peak(torch)
    fused_gated_ffn_kernel.launches = 0
    fused_gated_ffn_kernel.launches_by_dtype = {}
    t0 = time.monotonic()
    with ffn_launch_shapes(layers) as seen:
        trainer, lines = train_quietly(port_main, args)
    wall_s = time.monotonic() - t0
    launches = fused_gated_ffn_kernel.launches
    by_mix = dict(fused_gated_ffn_kernel.launches_by_dtype)
    own_mib = torch.cuda.max_memory_allocated() / 2**20 - held_mib
    log(f"[ref23] (b) python -m gnot_tpu_torch.main {' '.join(argv)}: {wall_s:.2f} s")
    for line in lines:
        if line:
            log(f"[ref23] (b)   {line}")
    check_reference_lines(lines, args.epochs)
    expected = expect_train_launches(trainer, launches, args.epochs, "ref23")
    shapes = sorted(set(seen))
    log(f"[ref23] (b) FFN launch shapes (x, x dtype, weight dtype) {shapes}, by dtype mix "
        f"{json.dumps(by_mix)}; the run's own peak device memory {own_mib:.1f} MiB")
    if shapes != [((4, 12288, 256), "bfloat16", "float32")] or by_mix != {
            "bf16-x/f32-w": expected}:
        raise RuntimeError(f"[ref23] (b) expected every launch at x [4, 12288, 256] in the "
                           f"training mix, got {shapes} {by_mix}")
    fused_gated_ffn_kernel.launches = 0
    layers.fused_gated_ffn = fused_gated_ffn_reference
    try:
        plain, _ = train_quietly(port_main, args)
    finally:
        layers.fused_gated_ffn = fused_gated_ffn
    if fused_gated_ffn_kernel.launches:
        raise RuntimeError("[ref23] (b) the plain-FFN run launched the kernel")
    metrics = lambda t: np.array([r.test_metric for r in t.history])  # noqa: E731
    got = max(worst_rel(np, step_losses(np, trainer), step_losses(np, plain)),
              worst_rel(np, metrics(trainer), metrics(plain)))
    log(f"[ref23] (b) step losses, kernel {step_losses(np, trainer).tolist()}")
    log(f"[ref23] (b) step losses, plain  {step_losses(np, plain).tolist()} (0 kernel launches)")
    log(f"[ref23] (b) vs the plain-FFN run, worst relative difference over step losses and test "
        f"metrics: {got:.3e} (bar BF16_TRAIN_REL {BF16_TRAIN_REL})")
    if got > BF16_TRAIN_REL:
        raise RuntimeError(f"[ref23] (b) the kernel run is {got} from the plain-FFN run")
    live_mix_check(torch, np, layers, trainer.model, (4, 12288, 256), "ref23")
    times: dict[str, list[float]] = {}
    for impl in ("pallas", "xla", "xla", "pallas"):
        times.setdefault(impl, []).append(
            statistics.median(step_times(torch, Trainer, trainer, impl)[1:]))
    log(f"[ref23] (b) step time at [4, 12288] bf16, host clock around each waited-for step, "
        f"median of steps 2..8, two turns each: "
        + "; ".join(f"ffn_impl={k} {[round(t, 3) for t in v]} ms" for k, v in times.items())
        + f" on {card}")
    # Where a step's time goes: forward, backward and optimizer, each waited
    # for, with the kernel and with ffn_impl=xla, in turns.
    batch = next(iter(trainer.train_loader))
    xla_trainer = fresh_trainer(Trainer, trainer, "xla")
    split: dict[str, list[dict]] = {"pallas": [], "xla": []}
    for impl in ("pallas", "xla", "xla", "pallas"):
        split[impl].append(step_phases(torch, batch_loss, xla_trainer if impl == "xla" else trainer,
                                       batch))
    for impl, runs in split.items():
        log(f"[ref23] (b) step phases at [4, 12288] bf16, ffn_impl={impl}, median of 5, host ms / "
            f"CUDA-event ms, two turns: " + "; ".join(
                f"{name} " + " | ".join(f"{r[name][0]:.3f} / {r[name][1]:.3f}" for r in runs)
                for name in runs[0]) + f" on {card}")
    out.update(ref_scale_train_launches=launches, ref_scale_peak_mib=own_mib,
               ref_scale_step_ms=times, ref_scale_step_phases=split)
    del trainer, plain, xla_trainer, batch

    # (c) Long context: heatsink3d at 16k and 64k points with remat, then
    # 64k without remat for its peak memory.
    long_launches, peaks = {}, {}
    for size, batch, remat in [(s_, b_, True) for s_, b_ in LONG_RUNS] + [(65536, 1, False)]:
        flags = [f for f in LONG_FLAGS if remat or f != "--remat"]
        argv = flags + ["--synth_size", str(size), "--batch_size", str(batch)]
        tag = f"{size}{'' if remat else ' no remat'}"
        held_mib = reset_peak(torch)
        fused_gated_ffn_kernel.launches = 0
        t0 = time.monotonic()
        with ffn_launch_shapes(layers) as seen:
            trainer, lines = train_quietly(port_main, port_main.build_parser().parse_args(argv))
        wall_s = time.monotonic() - t0
        launches = fused_gated_ffn_kernel.launches
        peaks[tag] = torch.cuda.max_memory_allocated() / 2**20 - held_mib
        check_reference_lines(lines, 1)
        cfg = trainer.model_cfg
        steps, eval_batches = trainer.host_step, len(trainer.test_loader)
        expected = 2 * cfg.n_attn_layers * ((2 if remat else 1) * steps + eval_batches)
        want_shapes = {(b, l, cfg.n_attn_hidden_dim) for b, l in loader_shapes(trainer)}
        got_shapes = {s for s, _, _ in seen}
        losses = step_losses(np, trainer)
        log(f"[ref23] (c) python -m gnot_tpu_torch.main {' '.join(argv)}: {wall_s:.2f} s; step "
            f"losses {losses.tolist()}; FFN launches {launches} = 2 x {cfg.n_attn_layers} blocks "
            f"x ({'2 x ' if remat else ''}{steps} train steps + {eval_batches} eval batches); "
            f"launch shapes {sorted(got_shapes)} (the loaders' {sorted(want_shapes)}), mixes "
            f"{sorted({(a, w) for _, a, w in seen})}; the run's own peak device memory "
            f"{peaks[tag]:.1f} MiB on {card}")
        if (launches != expected or got_shapes != want_shapes or not np.all(np.isfinite(losses))
                or {(a, w) for _, a, w in seen} != {("bfloat16", "float32")}):
            raise RuntimeError(f"[ref23] (c) {tag}: {launches} launches (expected {expected}), "
                               f"shapes {got_shapes} vs {want_shapes}")
        if remat:
            long_launches[str(size)] = launches
            live_mix_check(torch, np, layers, trainer.model, max(got_shapes, key=lambda s: s[0] * s[1]),
                           "ref23")
        del trainer
    log(f"[ref23] (c) peak device memory at 64k, B=1: {peaks['65536']:.1f} MiB with --remat, "
        f"{peaks['65536 no remat']:.1f} MiB without ({peaks['65536 no remat'] / peaks['65536']:.2f}x); "
        f"at 16k, B=2, with --remat: {peaks['16384']:.1f} MiB; on {card}")
    out.update(long_context_launches=long_launches, long_context_peak_mib=peaks)

    # (d) The four attention kernels on bf16 inputs at full width.
    wrappers = {"nla_reduce": fa.nla_reduce_kernel, "nla_apply": fa.nla_apply_kernel,
                "nla_reduce_seg": fa.nla_reduce_seg_kernel, "nla_apply_seg": fa.nla_apply_seg_kernel}
    cases = vk.full_width_cases(torch.device("cuda"))
    for w in wrappers.values():
        w.launches = 0
    checks = []
    for name in ("self", "cross", "self_packed", "cross_packed"):
        checks += vk.check_bf16(name, cases[name], vk.N_HEAD)
    bf16_launches = {n: w.launches for n, w in wrappers.items()}
    failed = [c.name for c in checks if not c.ok]
    log(f"[ref23] (d) {len(checks)} bf16 checks at full width, {len(failed)} failed; launches "
        f"{json.dumps(bf16_launches)}")
    if failed or not all(bf16_launches.values()):
        raise RuntimeError(f"[ref23] (d) bf16 attention checks failed: {failed}, launches "
                           f"{bf16_launches}")
    attn_out = {n: {"bf16_launches": bf16_launches[n]} for n in wrappers}

    # (e) Device time against the bound: the FFN kernel at the new shapes
    # in the training mix, and each attention kernel in bf16.
    ffn_rows = {}
    for b, l in REF_SHAPES:
        x, scores, kernels, biases = ffn_inputs(torch, np, b, l, 256, 3, 5, seed=b * l + 23)
        call_args = (x.bfloat16(), scores, kernels, biases)
        del x
        with torch.inference_mode():
            got_ = fused_gated_ffn_kernel(*call_args, gelu_kind="tanh")
            want_ = fused_gated_ffn_reference(*call_args, gelu_kind="tanh")
            err = (got_.float() - want_.float()).abs().max().item()
            torch.testing.assert_close(got_.float(), want_.float(), rtol=BF16_RTOL, atol=BF16_ATOL)
            del got_, want_
            ms = device_ms(torch, lambda: fused_gated_ffn_kernel(*call_args, gelu_kind="tanh"))
            plain_ms = device_ms(torch, lambda: fused_gated_ffn_reference(*call_args,
                                                                            gelu_kind="tanh"))
        bound_ms, bound_by = ffn_bound_ms(*call_args)
        blocks, waves = ffn_blocks(b * l, n_sm)
        log(f"[ref23] (e) FFN kernel at x [{b},{l},256] bf16, f32 weights, E=3 5 Linears tanh, "
            f"weights warm in L2: device time {ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
            f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of bound; {blocks} CTAs, "
            f"{waves:.2f} waves on {n_sm} SMs; max_abs_err vs plain {err:.3e}; at [4,1024,256] "
            f"(phase 3, 128 CTAs, {128 / n_sm:.2f} waves) {mix['mix_ms']:.4f} ms, "
            f"{mix['mix_bound_ms'] / mix['mix_ms']:.1%} of bound; on {card}")
        ffn_rows[f"{b}x{l}x256"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                        bound_by=bound_by, blocks=blocks, waves=waves,
                                        max_abs_err=err)
        del call_args, scores, kernels, biases
    out["ref_scale_shapes"] = ffn_rows

    n_head = vk.N_HEAD
    for name, case_name in (("nla_reduce", "self"), ("nla_apply", "self"),
                            ("nla_reduce_seg", "self_packed"), ("nla_apply_seg", "self_packed")):
        c = dict(cases[case_name])
        c.update({x: c[x].bfloat16() for x in ("q", "k", "v", "mask")})
        kv_args = (c["k"], c["v"], c["mask"])
        if name == "nla_reduce":
            kernel = lambda: fa.nla_reduce_kernel(*kv_args, n_head)  # noqa: E731
            plain = lambda: fa.reduce_reference(*kv_args, n_head)  # noqa: E731
        elif name == "nla_reduce_seg":
            seg = (c["kv_seg"], c["n_seg"], n_head)
            kernel = lambda: fa.nla_reduce_seg_kernel(*kv_args, *seg)  # noqa: E731
            plain = lambda: fa.reduce_seg_reference(*kv_args, *seg)  # noqa: E731
        elif name == "nla_apply":
            grams = fa.reduce_reference(*kv_args, n_head)
            kernel = lambda: fa.nla_apply_kernel(c["q"], *grams, n_head)  # noqa: E731
            plain = lambda: fa.apply_reference(c["q"], *grams, n_head)  # noqa: E731
        else:
            grams = fa.reduce_seg_reference(*kv_args, c["kv_seg"], c["n_seg"], n_head)
            kernel = lambda: fa.nla_apply_seg_kernel(c["q"], *grams, c["q_seg"], n_head)  # noqa: E731
            plain = lambda: fa.apply_seg_reference(c["q"], *grams, c["q_seg"], n_head)  # noqa: E731
        err = max((g.float() - w.float()).abs().max().item() for g, w in zip(kernel(), plain()))
        ms, plain_ms = device_ms(torch, kernel), device_ms(torch, plain)
        bound_ms, bound_by = attention_bounds(name, c, n_head, tensor_cores=True)
        f32 = attn[name]
        log(f"[ref23] (e) {name} {case_name} bf16 q {list(c['q'].shape)} k {list(c['k'].shape)}: "
            f"device time kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms "
            f"({bound_by}, bf16 bytes), {bound_ms / ms:.1%} of bound; the f32 instance (phase "
            f"3b) {f32['ms']:.4f} ms against {f32['bound_ms']:.4f} ({f32['bound_ms'] / f32['ms']:.1%}); "
            f"max_abs_err {err:.3e} on {card}")
        attn_out[name]["bf16"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                      bound_by=bound_by, max_abs_err=err)
    log(f"[ref23] phase 23 took {time.monotonic() - t_phase:.1f} s on {card}")
    return {"ffn": out, "attn": attn_out}



# -- phase 24: the bench and the tools built on it --------------------------------
BENCH_OUT = TRAIN_OUT / "bench24"
# Each bench run's windows: 5 and 20 steps, best of 2, no CPU baseline,
# unless the run says otherwise.
BENCH_WINDOWS = ["--k1", "5", "--k2", "20", "--repeats", "2", "--cpu_steps", "0"]
# The JSON line's keys, the JAX bench's (bench.py:469-480).
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "ms_per_step", "flops_per_step",
              "achieved_tflops", "mfu", "timing", "dtype"}
# (b): the per-step loop against the marginal of the same workload.
PERSSTEP_RATIO = (0.5, 2.0)
# (g): a packed request's output against its solo dispatch (tools/pack_ab.py).
PACK_AB_BAR = 1e-5


def bench_line(name: str, r: dict, peak_mib, card: str) -> str:
    tflops = "n/a" if r["achieved_tflops"] is None else f"{r['achieved_tflops']:.2f}"
    mfu = "null" if r["mfu"] is None else f"{r['mfu']:.4f}"
    peak = "not read" if peak_mib is None else f"{peak_mib:.1f} MiB"
    return (f"[bench] {name}: {r['metric']} dtype {r['dtype']} {r['ms_per_step']:.4f} ms/step "
            f"({r['timing']}), {r['value']:.1f} points/s, {tflops} TFLOP/s of products, "
            f"mfu {mfu}, vs_baseline {r['vs_baseline']}, peak {peak} on {card}")


def process_state(torch) -> str:
    """What this process carries into a host-bound measurement: its live
    threads by name, the lock-order guard's mode, the sync debug mode,
    torch's intra-op threads and the objects the collector tracks."""
    import collections
    import gc
    import threading

    from gnot_tpu_torch.utils import lockguard

    names = collections.Counter(re.sub(r"\d+", "N", t.name) for t in threading.enumerate())
    return (f"process state: {sum(names.values())} threads {dict(names)}, lock guard "
            f"{lockguard.installed_mode()}, sync debug mode {torch.cuda.get_sync_debug_mode()}, "
            f"torch threads {torch.get_num_threads()}, gc objects {len(gc.get_objects())}")


def bench_in_process(bench, name: str, argv: list[str]) -> dict:
    """``bench.main(argv + --mem_stats)`` in this process: its JSON line
    (checked for JAX's keys), the steps it ran and those through the FFN
    kernel (a step whose model runs the kernel path), the kernel's launches
    over the run, and ``--mem_stats`` (the timed windows' peak device
    memory). Fails with a ``[bench] <name>:`` error."""
    from gnot_tpu_torch.models.layers import GatedExpertFfn
    from gnot_tpu_torch.ops.fused_ffn import fused_gated_ffn_kernel

    real_step = bench.train_step
    counted = {"steps": 0, "kernel_steps": 0}

    def counting_step(state, batch, lr):
        ffn = next(m for m in state.model.modules() if isinstance(m, GatedExpertFfn))
        counted["steps"] += 1
        counted["kernel_steps"] += ffn.ffn_impl == "pallas"
        return real_step(state, batch, lr)

    out, err = io.StringIO(), io.StringIO()
    fused_gated_ffn_kernel.launches = 0
    bench.train_step = counting_step
    t0 = time.monotonic()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            result = bench.main([*argv, "--mem_stats"])
    except Exception as e:
        raise RuntimeError(f"[bench] {name}: {type(e).__name__}: {e}\n{err.getvalue()[-3000:]}") from e
    finally:
        bench.train_step = real_step
    wall = time.monotonic() - t0
    launches = fused_gated_ffn_kernel.launches
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    if line != result or set(line) != BENCH_KEYS:
        raise RuntimeError(f"[bench] {name}: printed {line}, returned {result}; keys "
                           f"{sorted(set(line) ^ BENCH_KEYS)} differ from the JAX bench's")
    if not result["value"] > 0:
        raise RuntimeError(f"[bench] {name}: value {result['value']}")
    notes = [ln for ln in err.getvalue().splitlines() if ln.strip()]
    mem = next((json.loads(ln) for ln in reversed(notes) if ln.startswith("{")), None)
    if mem is None or set(mem) != set(bench.MEM_KEYS) or not mem["peak_bytes_in_use"]:
        raise RuntimeError(f"[bench] {name}: --mem_stats printed {mem}")
    return dict(result=result, launches=launches, wall=wall, mem=mem,
                peak_mib=mem["peak_bytes_in_use"] / 2**20, **counted)


def bench_phase(torch, card: str) -> dict:
    """Phase 24: ``python -m gnot_tpu_torch.bench`` and the three tools built
    on it on the card, each run failing the phase with a ``[bench] <run>:``
    error. (a) NS2d-1k in bf16 and f32, ``--ffn_impl xla`` and ``pallas``,
    in this process: JAX's keys, ``scan_marginal``, ``mfu`` not null, one
    flop count for both FFN paths, 8 kernel launches a kernel step (the
    flop count's step runs the ``xla`` path); (b) ``--timing persstep``
    within ``PERSSTEP_RATIO`` of (a)'s marginal; (c) the other four
    ``--config``s; (d) ``--packed`` at pack_ab's train size and
    ``--flat_params``; (e) ``--n_points 12288`` through ``xla`` and the
    kernel with ``--mem_stats``; (f) the CPU baseline of one step, as
    ``python -m gnot_tpu_torch.bench`` without JAX; (g) ``honest_probe``,
    ``profile_step`` (without JAX) and ``pack_ab`` with its numerics bar.
    Returns the FFN entry's fields."""
    import shutil

    from gnot_tpu_torch import bench
    from gnot_tpu_torch.ops.fused_ffn import fused_gated_ffn_kernel
    from gnot_tpu_torch.tools import honest_probe, pack_ab

    t_phase = time.monotonic()
    shutil.rmtree(BENCH_OUT, ignore_errors=True)
    BENCH_OUT.mkdir(parents=True)
    log(f"[bench] {process_state(torch)}")
    k1, k2, repeats = 5, 20, 2
    window_steps = (k1 + k2) * (1 + repeats)  # one warm-up window and `repeats` timed, each K
    log(f"[bench] {bench.SCAN_MARGINAL_NOTE}")
    runs: dict[str, dict] = {}

    def run(name: str, argv: list[str]) -> dict:
        r = bench_in_process(bench, name, argv)
        runs[name] = r
        log(bench_line(name, r["result"], r["peak_mib"], card)
            + f" ({r['wall']:.1f} s wall, {r['steps']} steps)")
        return r

    # (a) The headline, both dtypes, both FFN paths.
    bench_launches = 0
    for dtype in ("bfloat16", "float32"):
        for ffn in ("xla", "pallas"):
            name = f"(a) ns2d {dtype} {ffn}"
            r = run(name, ["--dtype", dtype, "--ffn_impl", ffn, *BENCH_WINDOWS])
            res = r["result"]
            if res["timing"] != "scan_marginal" or res["mfu"] is None:
                raise RuntimeError(f"[bench] {name}: timing {res['timing']}, mfu {res['mfu']}")
            want_steps = window_steps if ffn == "pallas" else 0
            if r["kernel_steps"] != want_steps or r["launches"] != 8 * r["kernel_steps"]:
                raise RuntimeError(f"[bench] {name}: {r['launches']} FFN kernel launches over "
                                   f"{r['kernel_steps']} kernel steps (want 8 x {want_steps})")
            bench_launches += r["launches"]
        flops = {ffn: runs[f"(a) ns2d {dtype} {ffn}"]["result"]["flops_per_step"]
                 for ffn in ("xla", "pallas")}
        if flops["xla"] != flops["pallas"] or not flops["xla"]:
            raise RuntimeError(f"[bench] (a) ns2d {dtype}: flops_per_step {flops}")
        ms = {ffn: runs[f"(a) ns2d {dtype} {ffn}"]["result"]["ms_per_step"]
              for ffn in ("xla", "pallas")}
        log(f"[bench] (a) {dtype}: flops_per_step {flops['xla']:.0f} for both FFN paths; "
            f"kernel / xla ms per step {ms['pallas'] / ms['xla']:.3f}")
    log(f"[bench] (a) fused_gated_ffn launches {bench_launches} = 8 x {bench_launches // 8} "
        f"kernel steps ({window_steps} a pallas run: windows of {k1} and {k2}, one warm-up "
        f"and {repeats} timed each)")
    # The windows' restore writes the weights back in place: the kernel's
    # first step after it must run on images packed anew, not stale ones.
    losses = {}
    for ffn in ("xla", "pallas"):
        step, state, batch, _ = bench.build("float32", ffn_impl=ffn)
        dbatch = batch.to(state.device)
        start = bench._snapshot(state)
        first = step(state, dbatch, 1e-3)[1].item()
        step(state, dbatch, 1e-3)
        bench._restore(state, start)
        again = step(state, dbatch, 1e-3)[1].item()
        if again != first:
            raise RuntimeError(f"[bench] (a) restore {ffn}: step after the restore {again!r}, "
                               f"first step {first!r}")
        losses[ffn] = first
        del state
    rel = abs(losses["pallas"] - losses["xla"]) / abs(losses["xla"])
    log(f"[bench] (a) f32 step from one state: kernel {losses['pallas']!r}, xla "
        f"{losses['xla']!r} (relative {rel:.2e}, bar rtol {MODEL_RTOL}); each path's step after "
        "a restore bitwise its first")
    if not math.isclose(losses["pallas"], losses["xla"], rel_tol=MODEL_RTOL, abs_tol=MODEL_ATOL):
        raise RuntimeError(f"[bench] (a) restore: kernel {losses['pallas']} vs xla {losses['xla']}")

    # (b) The per-step loop against the marginal.
    r = run("(b) ns2d bfloat16 xla persstep", ["--timing", "persstep", "--repeats", "2",
                                               "--cpu_steps", "0"])
    ratio = r["result"]["ms_per_step"] / runs["(a) ns2d bfloat16 xla"]["result"]["ms_per_step"]
    log(f"[bench] (b) persstep / scan_marginal ms per step {ratio:.3f} "
        f"(bar {PERSSTEP_RATIO[0]}-{PERSSTEP_RATIO[1]})")
    if not PERSSTEP_RATIO[0] <= ratio <= PERSSTEP_RATIO[1]:
        raise RuntimeError(f"[bench] (b) persstep: {ratio:.3f} x the marginal")

    # (c) The other configs (ns2d is (a)'s).
    for config in ("darcy2d", "elasticity", "inductor2d", "heatsink3d"):
        run(f"(c) {config} bfloat16 xla", ["--config", config, *BENCH_WINDOWS])

    # (d) The layouts.
    run("(d) elasticity packed", ["--config", "elasticity", "--n_points", "256",
                                  "--batch_size", "16", "--packed", "--pack_chunk", "64",
                                  *BENCH_WINDOWS])
    run("(d) ns2d flat_params", ["--flat_params", *BENCH_WINDOWS])

    # (e) The reference's scale, through xla and the kernel.
    ref_launches = 0
    for ffn in ("xla", "pallas"):
        name = f"(e) ns2d 12288 {ffn}"
        r = run(name, ["--n_points", "12288", "--ffn_impl", ffn, *BENCH_WINDOWS])
        if r["launches"] != 8 * r["kernel_steps"]:
            raise RuntimeError(f"[bench] {name}: {r['launches']} launches over "
                               f"{r['kernel_steps']} kernel steps")
        ref_launches += r["launches"]
        log(f"[bench] {name} mem_stats {json.dumps(r['mem'])}")

    # (f) One CPU baseline, as a user runs the entry point, without JAX.
    argv = ["--k1", "5", "--k2", "20", "--repeats", "1", "--cpu_steps", "1"]
    try:
        proc, wall = no_jax_run("gnot_tpu_torch.bench", *argv)
    except RuntimeError as e:
        raise RuntimeError(f"[bench] (f) cpu baseline: {e}") from e
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    points = res["value"] * res["ms_per_step"] / 1e3
    cpu_s = points / (res["value"] / res["vs_baseline"])
    log(bench_line("(f) ns2d bfloat16 xla, --cpu_steps 1 --repeats 1", res, None, card))
    log(f"[bench] (f) the f32 CPU step: {cpu_s:.3f} s ({points:.0f} points), vs_baseline "
        f"{res['vs_baseline']}; the process took {wall:.1f} s wall")

    # (g) The tools.
    out = io.StringIO()
    t0 = time.monotonic()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
            line = honest_probe.main(["--k1", "5", "--k2", "20", "--windows", "2"])
    except Exception as e:
        raise RuntimeError(f"[bench] (g) honest_probe: {type(e).__name__}: {e}") from e
    log(f"[bench] (g) honest_probe: {line} ({time.monotonic() - t0:.1f} s wall) on {card}")
    prof_out = BENCH_OUT / "profile_breakdown.json"
    try:
        proc, wall = no_jax_run("gnot_tpu_torch.tools.profile_step", "--k", "5", "--top", "8",
                                "--out", str(prof_out), "--trace_dir", str(BENCH_OUT / "trace"))
    except RuntimeError as e:
        raise RuntimeError(f"[bench] (g) profile_step: {e}") from e
    prof = json.loads(prof_out.read_text())
    if not prof["kernel_records"] or prof["while_wrapper_ms_per_step"] is not None:
        raise RuntimeError(f"[bench] (g) profile_step: {prof_out} {prof}")
    log(f"[bench] (g) profile_step --k 5 ({wall:.1f} s wall): device busy "
        f"{prof['module_total_ms_per_step']:.4f} ms a step, device records "
        f"{prof['ops_total_ms_per_step']:.4f} ms a step, {prof['kernel_records']} kernel records "
        f"of {prof['launch_calls']} launch calls ({prof['records_lost']} without a record) "
        f"on {card}")
    for f_ in prof["op_families"]:
        log(f"[bench] (g)   {f_['ms_per_step']:8.4f} ms {f_['pct_of_ops']:5.1f}% "
            f"x{f_['count_per_step']:6.1f}  {f_['family'][:90]}")
    fused_gated_ffn_kernel.launches = 0
    out = io.StringIO()
    t0 = time.monotonic()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
            records = pack_ab.main(["--steps", "2", "--repeats", "1", "--serve_n", "8"])
    except Exception as e:
        raise RuntimeError(f"[bench] (g) pack_ab: {type(e).__name__}: {e}") from e
    pack_launches = fused_gated_ffn_kernel.launches
    summary = records[-1]
    log(f"[bench] (g) pack_ab ({time.monotonic() - t0:.1f} s wall, {pack_launches} FFN kernel "
        f"launches: both arms run ffn_impl=xla) {json.dumps(summary)} on {card}")
    if summary["platform"] != "gpu" or not summary["max_abs_diff"] <= PACK_AB_BAR:
        raise RuntimeError(f"[bench] (g) pack_ab: {summary}")
    log(f"[bench] phase 24 took {time.monotonic() - t_phase:.1f} s on {card}")
    return {"bench_launches": bench_launches, "bench_ref_scale_launches": ref_launches,
            "pack_ab_launches": pack_launches}


# -- phase 25: the overhead and chaos A/B tools ------------------------------------
AB_OUT = TRAIN_OUT / "ab25"
# (a): each tool's argv on the card (``--device cuda`` and its ``--out``
# are appended): the JAX defaults (metrics_ab and capacity_ab 400 requests x
# 3, dtrace_ab 32 x 3, rollout_ab 12 sessions x 6 steps, federation_ab 8 x
# 12) but for telemetry_ab's and tracing_ab's windows, cut from 60 steps x 3
# to 20 x 2 to keep the phase under AB_BUDGET_S (PERF.md §4).
AB_TOOLS = {
    "telemetry_ab": ["--steps", "20", "--repeats", "2"],
    "tracing_ab": ["--steps", "20", "--repeats", "2"],
    **{name: [] for name in ("metrics_ab", "capacity_ab", "dtrace_ab", "rollout_ab",
                             "federation_ab")},
}
# Each overhead A/B's arms and summary name, JAX's.
AB_NAMES = {
    "telemetry_ab": (("telemetry_off", "telemetry_on"), "telemetry_overhead"),
    "tracing_ab": (("tracing_off", "tracing_on"), "tracing_overhead"),
    "metrics_ab": (("metrics_off", "metrics_on"), "metrics_overhead"),
    "capacity_ab": (("capacity_off", "capacity_on"), "capacity_overhead"),
    "dtrace_ab": (("dtrace_off", "dtrace_on"), "dtrace_overhead"),
}
# (b): the reference-default model through the FFN kernel at NS2d-1k,
# batch 4, f32; windows of AB_STEPS steps, best of AB_REPEATS, the arms
# interleaved.
AB_MODEL = {"ffn_impl": "pallas"}
AB_POINTS, AB_BATCH, AB_STEPS, AB_REPEATS = 1024, 4, 10, 2
# The JAX package's overhead bar (tests/test_artifacts.py), reported only.
AB_OVERHEAD_BAR = 0.02
# The chaos A/Bs' parity bar (tools/rollout_ab.py, tools/federation_ab.py).
AB_PARITY_BAR = 1e-5
AB_BUDGET_S = 120.0
# The seven processes' start-up, side by side, up to their "ready" gates.
AB_READY_TIMEOUT_S = 120.0
# A tool's process this long after its release gets SIGABRT (its threads'
# stacks are kept): under the chaos A/Bs' own 180 s waits.
AB_TOOL_TIMEOUT_S = 150.0


# (a)'s runner: NO_JAX with a prelude that imports torch, the port's heavy
# modules and the tool, opens the CUDA context, prints "ready" and waits
# for a line on stdin before it runs the tool. The seven processes start
# together and pay their start-up (~11-15 s each on the card host) side by
# side; each tool then runs alone, released when the one before it exits.
AB_WARM_MODULES = ("gnot_tpu_torch.train.trainer", "gnot_tpu_torch.serve.server",
                   "gnot_tpu_torch.serve.router", "gnot_tpu_torch.serve.federation",
                   "gnot_tpu_torch.obs.metrics")
AB_RUNNER = NO_JAX.replace("target, sys.argv = sys.argv[1], sys.argv[1:]\n", f"""\
import importlib, torch
for _m in {AB_WARM_MODULES!r} + tuple(m for m in sys.argv[1:2] if m != "-c"):
    importlib.import_module(_m)
torch.zeros(1, device="cuda").sum().item()
print("ready", flush=True)
sys.stdin.readline()
target, sys.argv = sys.argv[1], sys.argv[1:]
""")


def ab_tool_start(name: str, argv: list[str], target: list[str] | None = None):
    """``python -m gnot_tpu_torch.tools.<name> <argv>`` under
    ``AB_RUNNER`` (JAX unimportable), started and left at its "ready"
    gate; its stderr goes to ``<out>.stderr.txt``. ``target`` (``["-c",
    source]``) runs ``source`` with ``<argv>`` in place of the module."""
    out = Path(argv[argv.index("--out") + 1])
    err = open(out.with_name(out.name + ".stderr.txt"), "w")
    env = {**os.environ, "PYTHONFAULTHANDLER": "1"}
    target = target or [f"gnot_tpu_torch.tools.{name}"]
    proc = subprocess.Popen([sys.executable, "-c", AB_RUNNER, *target, *argv], cwd=ROOT, env=env,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err, text=True)
    err.close()
    return proc


def ab_tool_error(name: str, argv: list[str], proc, gate: str, wall: float,
                  stdout: str = "") -> RuntimeError:
    """The ``[ab] <name>:`` error of a tool that failed: its argv, exit
    code, gate line, stdout tail and the last lines of its stderr file."""
    out = Path(argv[argv.index("--out") + 1])
    err_path = out.with_name(out.name + ".stderr.txt")
    lines = err_path.read_text().strip().splitlines()
    threads = [ln for ln in lines if ln.startswith("Exception in thread")]
    tail = "\n".join(lines[-60:])
    return RuntimeError(f"[ab] {name} {' '.join(argv)}: exit {proc.returncode} after "
                        f"{wall:.1f} s (gate read {gate!r}); {threads}\nstdout: "
                        f"{stdout[-2000:]}\nstderr ({err_path}, last "
                        f"lines):\n{tail}")


def ab_abort(proc) -> str:
    """SIGABRT a tool's process (Python's fault handler writes every
    thread's stack to its stderr file) and return its stdout's rest."""
    import signal

    proc.send_signal(signal.SIGABRT)
    return proc.communicate(timeout=60)[0]


def ab_tool_ready(name: str, argv: list[str], proc, deadline: float) -> None:
    """Wait, until the monotonic ``deadline``, for a started tool's
    "ready" line. A process that ends first, prints another line or is
    still starting at the deadline is aborted and fails with its
    ``[ab] <name>:`` error."""
    import select

    t0 = time.monotonic()
    gate = ""
    if select.select([proc.stdout], [], [], max(0.0, deadline - t0))[0]:
        gate = proc.stdout.readline().strip()
    if gate != "ready":
        stdout = ab_abort(proc) if proc.poll() is None else proc.communicate(timeout=60)[0]
        raise ab_tool_error(name, argv, proc, gate or "nothing by the deadline",
                            time.monotonic() - t0, stdout)


def ab_tool_finish(name: str, argv: list[str], proc) -> tuple[list[dict], float]:
    """Release a tool already at its "ready" gate, wait for it alone and
    return its ``--out`` records and its wall seconds from the release. A
    process still running ``AB_TOOL_TIMEOUT_S`` after it is aborted. Fails
    with its ``[ab] <name>:`` error on a non-zero exit or without the
    no-JAX runner's closing note."""
    out = Path(argv[argv.index("--out") + 1])
    t0 = time.monotonic()
    try:
        stdout, _ = proc.communicate("go\n", timeout=AB_TOOL_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        stdout = ab_abort(proc)
    wall = time.monotonic() - t0
    lines = out.with_name(out.name + ".stderr.txt").read_text().strip().splitlines()
    if proc.returncode != 0 or not (lines or [""])[-1].startswith(
            "no-jax: refused [] loaded []"):
        raise ab_tool_error(name, argv, proc, "ready", wall, stdout)
    return read_jsonl(out), wall


def check_overhead_records(name: str, recs: list[dict]) -> dict:
    """An overhead A/B's records: JAX's arm and summary names, platform
    "gpu", and the summary's arithmetic (``on / off - 1`` for a time,
    ``1 - on / off`` for a rate, rounded to 4 places as JAX's). Returns the
    summary."""
    arms, summary_name = AB_NAMES[name]
    [summary] = [r for r in recs if "summary" in r]
    got_arms = tuple(r["arm"] for r in recs if "arm" in r)
    if got_arms != arms or summary["summary"] != summary_name or any(
            r["platform"] != "gpu" for r in recs if "arm" in r):
        raise RuntimeError(f"[ab] {name}: arms {got_arms}, summary {summary['summary']}, "
                           f"platforms {[r.get('platform') for r in recs]}")
    key = next(k for k in ("ms_per_step", "ms_per_request", "requests_per_s") if k in recs[0])
    off, on = recs[0][key], recs[1][key]
    frac = round(1.0 - on / off, 4) if key == "requests_per_s" else round(on / off - 1.0, 4)
    if summary["overhead_frac"] != frac:
        raise RuntimeError(f"[ab] {name}: overhead_frac {summary['overhead_frac']} != {frac} "
                           f"from {key} {off} / {on}")
    return summary


def check_chaos_summary(name: str, s: dict) -> None:
    """The chaos A/Bs' asserted bars on their summary record (the process
    exits 1 on any of JAX's own ``failures``; these are read back)."""
    if name == "rollout_ab":
        ok = (s["lost_migration"] == 0 and s["lost_no_migration"] >= 1 and s["migrated"] >= 1
              and s["max_abs_diff"] <= AB_PARITY_BAR)
    else:
        ok = (s["lost_chaos"] == 0 and s["lost_no_failover"] >= 1 and s["remigrated"] >= 1
              and s["max_abs_diff"] <= AB_PARITY_BAR and s["single_host_byte_identical"] is True)
    if not ok:
        raise RuntimeError(f"[ab] {name}: a correctness bar broke: {json.dumps(s)}")


def ab_tools_phase(torch, card: str) -> dict:
    """Phase 25: (a) the seven A/B tools on the card, one process each
    under ``NO_JAX``, their records checked; (b) ``telemetry_ab``'s and
    ``tracing_ab``'s windows in this process on the reference-default
    model through the FFN kernel, every launch counted; (c) the phase's
    seconds against ``AB_BUDGET_S``. Returns the FFN entry's field."""
    import shutil

    from gnot_tpu_torch.models.layers import GatedExpertFfn
    from gnot_tpu_torch.ops.fused_ffn import fused_gated_ffn_kernel
    from gnot_tpu_torch.tools import telemetry_ab, tracing_ab

    t_phase = time.monotonic()
    shutil.rmtree(AB_OUT, ignore_errors=True)
    AB_OUT.mkdir(parents=True)

    # (a) Each tool in a process of its own: all started at once, each run
    # alone in turn.
    argvs = {name: [*flags, "--device", "cuda", "--out", str(AB_OUT / f"{name}.jsonl")]
             for name, flags in AB_TOOLS.items()}
    procs = {name: ab_tool_start(name, argv) for name, argv in argvs.items()}
    walls = {}
    try:
        deadline = time.monotonic() + AB_READY_TIMEOUT_S
        for name in AB_TOOLS:  # all seven at their gates before the first goes
            ab_tool_ready(name, argvs[name], procs[name], deadline)
        log(f"[ab] (a) all seven at their gates {time.monotonic() - t_phase:.1f} s into "
            "the phase")
        ran = [(name, *ab_tool_finish(name, argvs[name], procs[name])) for name in AB_TOOLS]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    log(f"[ab] (a) seven processes started together, each run alone once released: all "
        f"done {time.monotonic() - t_phase:.1f} s into the phase ({sum(w for *_, w in ran):.1f} "
        "s of it released)")
    for name, recs, wall in ran:
        argv = argvs[name]
        walls[name] = wall
        if name in AB_NAMES:
            summary = check_overhead_records(name, recs)
            if name == "metrics_ab" and not summary["snapshots_on"] >= 1:
                raise RuntimeError(f"[ab] metrics_ab: no publisher snapshot: {summary}")
            if name == "capacity_ab" and not summary["attributed_dispatches"] > 0:
                raise RuntimeError(f"[ab] capacity_ab: no attributed dispatch: {summary}")
            bar = "hit" if summary["overhead_frac"] < AB_OVERHEAD_BAR else "missed"
            note = f"JAX's 2% bar {bar} (reported, not asserted)"
        else:
            check_chaos_summary(name, recs[-1])
            note = "correctness bars hold"
        log(f"[ab] (a) python -m gnot_tpu_torch.tools.{name} {' '.join(argv)} "
            f"({walls[name]:.1f} s wall, no JAX): {note}; records "
            f"{json.dumps(recs)} on {card}")

    # (b) The reference-default model through the FFN kernel: one trainer,
    # put back to its start state before every window.
    _, state, batch = telemetry_ab.build(False, AB_POINTS, AB_BATCH, model_kwargs=AB_MODEL)
    impls = {m.ffn_impl for m in state.model.modules() if isinstance(m, GatedExpertFfn)}
    if impls != {"pallas"}:
        raise RuntimeError(f"[ab] (b): the model's FFNs run {impls}")
    restore = telemetry_ab.restorer(state)
    per_step = 2 * state.model.config.n_attn_layers
    arms = (("telemetry_off", telemetry_ab, telemetry_ab.plain_step, False, 10),
            ("telemetry_on", telemetry_ab, telemetry_ab.instrumented_step, True, 10),
            ("tracing_off", tracing_ab, tracing_ab.device_step, False, 1.0),
            ("tracing_on", tracing_ab, tracing_ab.device_step, True, 1.0))
    best = {arm: float("inf") for arm, *_ in arms}
    fused_gated_ffn_kernel.launches = 0
    steps_run = 0
    for _ in range(AB_REPEATS):
        for arm, tool, step, on, knob in arms:  # knob: log_every or sample_rate
            best[arm] = min(best[arm], tool._window(step, state, batch, on, AB_STEPS, knob,
                                                    restore, 1e-3))
            steps_run += AB_STEPS + 1
    launches = fused_gated_ffn_kernel.launches
    ms = {k: round(v * 1e3, 4) for k, v in best.items()}
    fracs = {k: round(ms[f"{k}_on"] / ms[f"{k}_off"] - 1.0, 4) for k in ("telemetry", "tracing")}
    log(f"[ab] (b) the reference-default model (4 blocks, width 256, 3 experts, 8 heads) "
        f"through the FFN kernel, NS2d-{AB_POINTS} batch {AB_BATCH} f32, windows of "
        f"{AB_STEPS} steps, best of {AB_REPEATS}, arms interleaved: ms a step {ms}; "
        f"overhead_frac {fracs} (JAX's 2% bar: "
        f"{ {k: 'hit' if v < AB_OVERHEAD_BAR else 'missed' for k, v in fracs.items()} }, "
        f"reported, not asserted); fused_gated_ffn launches {launches} = {per_step} x "
        f"{steps_run} steps (warm-up and timed, both arms of both A/Bs) on {card}")
    if launches != per_step * steps_run:
        raise RuntimeError(f"[ab] (b): {launches} FFN kernel launches over {steps_run} steps "
                           f"(want {per_step} a step)")
    del state, restore

    # (c) The phase's time.
    took = time.monotonic() - t_phase
    log(f"[ab] (c) tool wall s {json.dumps({k: round(v, 1) for k, v in walls.items()})}; "
        f"phase 25 took {took:.1f} s (budget {AB_BUDGET_S:.0f} s: "
        f"{'within' if took < AB_BUDGET_S else 'OVER'}) on {card}")
    return {"abtools_launches": launches}


# -- phase 26: the open-loop serving load tools ------------------------------------
LOAD_OUT = TRAIN_OUT / "load26"
# (a): the four tools with an argv, each at JAX's --quick sizes on the card,
# each through its run() (as JAX's own tests run serve_bench and
# lowprec_ab), the returned summary's failures (tenant_ab, autoscale_ab)
# written beside its --out. Each tool's main also holds capacity bars (a
# sustained rate, a p99 under an SLO set from one idle dispatch, saved
# replica-seconds, the native packer's gain) that one card misses: its
# replicas share the card and the host, and serve_bench --trace_path shows
# each replica thread's dispatch stretched by the others (PERF.md §5, §6).
# The phase asserts the correctness bars and reports the capacity bars.
LOAD_TOOLS = ("serve_bench", "lowprec_ab", "tenant_ab", "autoscale_ab")
LOAD_RUN = ("import json, sys\nfrom gnot_tpu_torch.tools import {name}\n"
            "s = {name}.run(sys.argv[1:])\n"
            "out = sys.argv[sys.argv.index('--out') + 1]\n"
            "with open(out + '.failures.json', 'w') as f:\n"
            "    json.dump(s.get('failures'), f)\n")
# serve_bench's --quick window and seed (the traces its records are
# recomputed from).
LOAD_QUICK_S, LOAD_SEED = 2.0, 0
# loadgen's traces for one seed (``loadgen_digest``): the digest the CPU
# gives, where tests/test_torch_load_tools.py holds the same traces
# bitwise to tools/loadgen.py's.
LOADGEN_DIGEST = "50238dc7976fbecd4afaa00249d3500647587c9e8d5bf986b51bbde1f6f9a360"
LOADGEN_RUN = ("from chip_smoke import loadgen_digest\n"
               "from gnot_tpu_torch.tools import loadgen\nprint(loadgen_digest(loadgen))\n")
# (b): serve_bench's functions on the reference-default model through the
# FFN kernel: its --quick loads and window, 1 and 2 replicas.
LOAD_LOADS, LOAD_REPLICAS = (0.6, 2.4), (1, 2)
# serve_bench's --max_shed_frac default: the shed share a sustained run may have.
LOAD_MAX_SHED = 0.02
LOAD_BUDGET_S = 120.0


def loadgen_digest(loadgen) -> str:
    """sha256 over ``loadgen``'s traces for seed 0: every pattern's
    ``trace_times`` and ``ramp_split``, and a two-tenant
    ``multi_stream_times`` with its tenant order."""
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for pattern in loadgen.PATTERNS:
        times = loadgen.trace_times(pattern, base_rps=40.0, duration_s=5.0, seed=0)
        h.update(np.asarray(times, np.float64).tobytes())
        h.update(str(loadgen.ramp_split(times, 5.0)).encode())
    merged = loadgen.multi_stream_times(
        {"interactive": {"pattern": "steady", "base_rps": 30.0},
         "batch": {"pattern": "diurnal_bursty", "base_rps": 60.0, "peak_mult": 2.0}},
        duration_s=5.0, seed=0)
    h.update(np.asarray([t for t, _ in merged], np.float64).tobytes())
    h.update(",".join(name for _, name in merged).encode())
    return h.hexdigest()


class RecordingRouter:
    """A router whose ``submit`` keeps each (sample, future) pair, so the
    served outputs of an open-loop run can be held to the plain forward."""

    def __init__(self, router):
        self.router = router
        self.served: list = []

    def start(self):
        self.router.start()
        return self

    def submit(self, sample):
        fut = self.router.submit(sample)
        self.served.append((sample, fut))
        return fut

    def drain(self):
        return self.router.drain()


def check_load_tools(recs: dict, failures: dict, loadgen) -> tuple[dict, list[str]]:
    """(a)'s records: the correctness bars asserted, every ``serve_bench``
    run's arrivals recomputed from ``loadgen``, and the capacity bars of
    each tool's ``main`` (JAX's) returned as "bar: hit" / "bar: missed"
    lines. A ``failures`` entry of ``tenant_ab`` or ``autoscale_ab`` other
    than its capacity bar's fails the phase. Returns (summaries, verdicts)."""
    summaries = {name: next(r for r in rows if r.get("summary") == name)
                 for name, rows in recs.items()}
    verdicts = []

    def report(tool: str, bar: str, hit: bool) -> bool:
        verdicts.append(f"{tool} {bar}: {'hit' if hit else 'missed'}")
        return not hit

    sb = summaries["serve_bench"]
    runs = [r for r in recs["serve_bench"] if "arm" in r]
    if ({r["arm"] for r in runs} != {"replicas_1", f"replicas_{sb['replicas_n']}"}
            or not sb["max_abs_diff"] <= sb["bar_numeric"]):
        raise RuntimeError(f"[ab] serve_bench: a bar broke: {json.dumps(sb)}")
    loads = sorted({r["load_mult"] for r in runs})
    for r in runs:
        times = loadgen.trace_times("steady", base_rps=r["offered_rps"], duration_s=LOAD_QUICK_S,
                                    seed=LOAD_SEED + loads.index(r["load_mult"]))
        if (r["submitted"] != len(times)
                or r["completed"] + sum(r["shed"].values()) != r["submitted"]):
            raise RuntimeError(f"[ab] serve_bench: run {r} against {len(times)} arrivals")
    for n in ("1", "n"):
        report("serve_bench", f"sustained_rps_{n} {sb[f'sustained_rps_{n}']} (p99 <= "
               f"{sb['slo_p99_ms']} ms, shed <= {sb['max_shed_frac']})",
               sb[f"sustained_rps_{n}"] is not None)
    report("serve_bench", f"speedup {sb['speedup']} >= bar_speedup {sb['bar_speedup']}",
           (sb["speedup"] or 0) >= sb["bar_speedup"])
    lp = summaries["lowprec_ab"]
    if not lp["parity_max_delta"] <= lp["parity_bar"]:
        raise RuntimeError(f"[ab] lowprec_ab: a bar broke: {json.dumps(lp)}")
    report("lowprec_ab", f"host_reduction_frac {lp['host_reduction_frac']} > 0",
           (lp["host_reduction_frac"] or 0) > 0)
    report("lowprec_ab", f"sustained_rps_bf16 {lp['sustained_rps_bf16']} (p99 <= "
           f"{lp['slo_p99_ms']} ms)", lp["sustained_rps_bf16"] is not None)
    ta = summaries["tenant_ab"]
    iso = next(r for r in recs["tenant_ab"] if r.get("arm") == "isolated")
    p99_missed = report("tenant_ab", f"isolated interactive p99 {ta['isolated_interactive_p99_ms']}"
                        f" ms <= SLO {ta['slo_p99_ms']} ms",
                        ta["isolated_interactive_p99_ms"] <= ta["slo_p99_ms"])
    if not (len(failures["tenant_ab"]) == int(p99_missed)
            and ta["isolated_interactive_shed"] == 0 and ta["pin_tenant_footprint"] == 0
            and ta["flood_factor"] >= ta["bar_flood_factor"]
            and ta["isolated_batch_quota_sheds"] >= 1
            and sum(t["submitted"] for t in iso["tenants"].values()) == ta["arrivals"]
            and all(t["completed"] + t["shed_total"] == t["submitted"]
                    for t in iso["tenants"].values())):
        raise RuntimeError(f"[ab] tenant_ab: a bar broke: {failures['tenant_ab']} "
                           f"{json.dumps(ta)}")
    au = summaries["autoscale_ab"]
    rs_missed = report("autoscale_ab", f"replica-seconds {au['replica_seconds_autoscaled']} < "
                       f"static {au['replica_seconds_static']}",
                       au["replica_seconds_autoscaled"] < au["replica_seconds_static"])
    if not (len(failures["autoscale_ab"]) == int(rs_missed)
            and au["chaos_lost_sessions"] == 0 and au["chaos_lost_requests"] == 0
            and au["chaos_max_abs_diff"] <= AB_PARITY_BAR and au["scale_ups"] >= 1):
        raise RuntimeError(f"[ab] autoscale_ab: a bar broke: {failures['autoscale_ab']} "
                           f"{json.dumps(au)}")
    return summaries, verdicts


def load_full_width(torch, np, card: str, layers) -> int:
    """Phase 26 (b): ``serve_bench``'s ``make_replicas``, ``fresh_router``,
    ``run_arm`` and ``numerics_check`` on the reference-default model
    through the FFN kernel; every launch counted, every served output held
    to the plain forward. Returns the launches."""
    from gnot_tpu_torch.config import ModelConfig
    from gnot_tpu_torch.data import datasets
    from gnot_tpu_torch.models.gnot import GNOT
    from gnot_tpu_torch.ops.fused_ffn import fused_gated_ffn_kernel
    from gnot_tpu_torch.tools import serve_bench, serve_smoke

    t_b = time.monotonic()
    samples = datasets.synth_darcy2d(4, seed=0, grid_n=8)
    mc = ModelConfig(ffn_impl="pallas", **datasets.infer_model_dims(samples))
    model = GNOT(mc, generator=torch.Generator().manual_seed(0)).to("cuda")
    traffic = serve_smoke.mixed_traffic(16, seed=LOAD_SEED, mesh_lo=600, mesh_hi=1000)
    plain = plain_outputs(torch, layers, model, traffic)
    dispatch_s = serve_bench.dispatch_seconds(model, traffic, max_batch=4)
    cap1 = 4 / dispatch_s
    slo = serve_bench.auto_slo_ms(dispatch_s)
    per_dispatch = 2 * mc.n_attn_layers
    torch.cuda.synchronize()
    fused_gated_ffn_kernel.launches = 0
    pools = {n: serve_bench.make_replicas(model, n, max_batch=4, traffic=traffic)
             for n in LOAD_REPLICAS}
    runs, served = [], []
    for li, mult in enumerate(LOAD_LOADS):
        for n in LOAD_REPLICAS:
            router = RecordingRouter(serve_bench.fresh_router(pools[n][0], max_batch=4))
            rec = serve_bench.run_arm(router, traffic, offered_rps=mult * cap1,
                                      duration_s=LOAD_QUICK_S, seed=LOAD_SEED + li)
            runs.append({"replicas": n, "load_mult": mult, **rec})
            served += router.served
    torch.cuda.synchronize()
    launches = fused_gated_ffn_kernel.launches
    warmed = sum(warm["programs_warmed"] for _, warm in pools.values())
    dispatches = sum(r["dispatches"] for r in runs)
    if launches != per_dispatch * (dispatches + warmed) or launches == 0:
        raise RuntimeError(f"[load] (b): {launches} FFN kernel launches, want {per_dispatch} x "
                           f"({dispatches} dispatches + {warmed} warm-ups)")
    by_id = {id(s): want for s, want in zip(traffic, plain)}
    results = [fut.result(timeout=0) for _, fut in served]
    ok = [(r, by_id[id(s)]) for (s, _), r in zip(served, results) if r.ok]
    worst = hold_to_plain(np, "load", [r for r, _ in ok], [want for _, want in ok])
    replicated = serve_bench.numerics_check(model, pools[2][0], traffic, max_batch=4)
    if not replicated <= AB_PARITY_BAR:
        raise RuntimeError(f"[load] (b): replicated vs solo {replicated} over {AB_PARITY_BAR}")
    sustained = {n: serve_bench.sustained([r for r in runs if r["replicas"] == n],
                                          slo_p99_ms=slo, max_shed_frac=LOAD_MAX_SHED)
                 for n in LOAD_REPLICAS}
    log(f"[load] (b) the reference-default model (4 blocks, width 256, 3 experts, 8 heads) "
        f"through the FFN kernel, f32, serve_smoke.mixed_traffic (16 samples, darcy64 and "
        f"600-1000-point clouds), max_batch 4: dispatch {dispatch_s * 1e3:.2f} ms -> 1-replica "
        f"capacity {cap1:.1f} req/s, p99 SLO {slo} ms; runs {json.dumps(runs)} on {card}")
    log(f"[load] (b) sustained (shed <= {LOAD_MAX_SHED:.0%}, p99 <= {slo} ms): "
        f"{ {n: (s['achieved_rps'], s['p99_ms']) if s else None for n, s in sustained.items()} } "
        f"(req/s, p99 ms) for 1 / 2 replicas; fused_gated_ffn launches {launches} = "
        f"{per_dispatch} x ({dispatches} dispatches + {warmed} warm-ups) over both pools, no "
        f"fallback; {len(ok)} served outputs vs the plain forward max_abs_err {worst:.3e} "
        f"(rtol {MODEL_RTOL} atol {MODEL_ATOL}); replicated vs solo {replicated:.3e} "
        f"({time.monotonic() - t_b:.1f} s)")
    return launches


def load_tools_phase(torch, np, card: str, layers) -> dict:
    """Phase 26: (a) the open-loop serving load tools on the card, each in a
    process of its own under ``NO_JAX``, the correctness bars asserted and
    the capacity bars reported; (b) ``load_full_width``; (c) the phase's
    seconds. Returns the FFN entry's field."""
    import shutil

    from gnot_tpu_torch.tools import loadgen

    t_phase = time.monotonic()
    shutil.rmtree(LOAD_OUT, ignore_errors=True)
    LOAD_OUT.mkdir(parents=True)

    # (a) The four tools in processes of their own, started together;
    # loadgen's own process runs while they start.
    argvs = {name: ["--quick", "--device", "cuda", "--out", str(LOAD_OUT / f"{name}.jsonl")]
             for name in LOAD_TOOLS}
    procs = {name: ab_tool_start(name, argvs[name], ["-c", LOAD_RUN.format(name=name)])
             for name in LOAD_TOOLS}
    walls = {}
    try:
        proc, walls["loadgen"] = no_jax_run("-c", LOADGEN_RUN)
        digest = proc.stdout.strip()
        if digest != LOADGEN_DIGEST or loadgen_digest(loadgen) != LOADGEN_DIGEST:
            raise RuntimeError(f"[ab] loadgen: traces digest {digest} (process of its own), "
                               f"{loadgen_digest(loadgen)} (here), want {LOADGEN_DIGEST}")
        deadline = time.monotonic() + AB_READY_TIMEOUT_S
        for name in LOAD_TOOLS:  # all four at their gates before the first goes
            ab_tool_ready(name, argvs[name], procs[name], deadline)
        log(f"[load] (a) all four at their gates {time.monotonic() - t_phase:.1f} s into the "
            f"phase; loadgen alone without JAX {walls['loadgen']:.1f} s, traces bitwise the "
            "CPU's (digest of tools/loadgen.py's, tests/test_torch_load_tools.py)")
        ran = {name: ab_tool_finish(name, argvs[name], procs[name]) for name in LOAD_TOOLS}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    recs = {name: rows for name, (rows, _) in ran.items()}
    walls.update({name: wall for name, (_, wall) in ran.items()})
    failures = {name: json.loads((LOAD_OUT / f"{name}.jsonl.failures.json").read_text())
                for name in LOAD_TOOLS}
    for name in LOAD_TOOLS:
        log(f"[load] (a) python -m gnot_tpu_torch.tools.{name} {' '.join(argvs[name])} "
            f"through run() ({walls[name]:.1f} s wall, no JAX): failures "
            f"{json.dumps(failures[name])}; records {json.dumps(recs[name])} on {card}")
    summaries, verdicts = check_load_tools(recs, failures, loadgen)
    log(f"[load] (a) correctness bars hold (serve_bench replicated vs solo "
        f"{summaries['serve_bench']['max_abs_diff']:.3e}, lowprec_ab parity "
        f"{summaries['lowprec_ab']['parity_max_delta']}, tenant_ab 0 interactive shed and the "
        f"rollup, autoscale_ab 0 lost sessions and requests, parity "
        f"{summaries['autoscale_ab']['chaos_max_abs_diff']:.3e}); capacity bars of each "
        f"main (reported, not asserted: replica threads share one card and one host, each "
        f"one's dispatch stretched by the others; PERF.md §5): "
        f"{'; '.join(verdicts)} on {card}")

    # (b) The reference-default model through the FFN kernel under
    # serve_bench's open-loop load.
    launches = load_full_width(torch, np, card, layers)

    # (c) The phase's time.
    took = time.monotonic() - t_phase
    log(f"[load] (c) summaries {json.dumps(summaries)}; tool wall s "
        f"{json.dumps({k: round(v, 1) for k, v in walls.items()})}; phase 26 took {took:.1f} s "
        f"(budget {LOAD_BUDGET_S:.0f} s: {'within' if took < LOAD_BUDGET_S else 'OVER'}) "
        f"on {card}")
    return {"load_tools_launches": launches}


def _tensor_leaves(tree):
    if hasattr(tree, "is_cuda"):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensor_leaves(v)


def main() -> int:
    if not (ROOT / "gnot_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no gnot_tpu_torch package beside {__file__}; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device", file=sys.stderr)
        return 1

    from gnot_tpu_torch import main as port_main
    from gnot_tpu_torch.device import resolve_device
    from gnot_tpu_torch.models import layers
    from gnot_tpu_torch.ops import build, fused_attention
    from gnot_tpu_torch.ops.fused_ffn import (
        fused_gated_ffn,
        fused_gated_ffn_kernel,
        fused_gated_ffn_reference,
    )
    from gnot_tpu_torch.serve.engine import InferenceEngine

    resolve_device("cuda")  # also turns TF32 off
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    card = card_line()
    log(card)

    # -- phase 2: build every kernel, all nvcc processes at once --------
    t0 = time.monotonic()
    procs = {name: build.start_build(name) for name in build.sources()}
    for name, proc in procs.items():
        report = build.finish_build(name, proc)
        log(f"[build] {name}: {build.library_path(name).relative_to(ROOT)}")
        for line in report.splitlines():
            if "ptxas" in line:
                log(f"[build]   {line.strip()}")
        regs, spills = build.ptxas_summary(report)
        log(f"[build] {name}: registers {regs} a thread over its {len(regs)} kernel instance(s), "
            f"spill stores + loads {spills} B")
    log(f"[build] {len(procs)} kernel(s) built in {time.monotonic() - t0:.1f} s")
    for name, opcode in (("fused_gated_ffn", "HGMMA"), ("nla_reduce", "HMMA")):
        n_mma = sass_count(build, name, opcode)
        log(f"[build] {name} SASS: {n_mma} {opcode} (tensor-core) instructions")
        if n_mma == 0:
            raise RuntimeError(f"lib{name}.so has no {opcode} instruction: not on the tensor cores")

    # -- phase 3: each kernel against its plain version on the card -----
    width, n_expert, n_linears = 256, 3, 5
    max_abs = 0.0
    for (b, l), gelu in [((4, 1024), "tanh"), ((4, 1024), "erf"),
                         ((4, 1000), "tanh"), ((3, 1000), "erf")]:
        args = ffn_inputs(torch, np, b, l, width, n_expert, n_linears, seed=b * l)
        got = fused_gated_ffn_kernel(*args, gelu_kind=gelu)
        want = fused_gated_ffn_reference(*args, gelu_kind=gelu)
        torch.cuda.synchronize()
        err = (got - want).abs()
        rel = (err / want.abs().clamp_min(1e-3)).max().item()
        log(f"[ffn] x [{b},{l},{width}] E={n_expert} {n_linears} Linears gelu={gelu}: "
            f"max_abs_err {err.max().item():.3e} max_rel_err {rel:.3e} "
            f"(tolerance rtol {KERNEL_RTOL} atol {KERNEL_ATOL}: 3xTF32 against f32, "
            "another summation order over K=256 through 5 chained Linears)")
        torch.testing.assert_close(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
        max_abs = max(max_abs, err.max().item())

    args = ffn_inputs(torch, np, 4, 1024, width, n_expert, n_linears, seed=7)
    kernel_call = lambda: fused_gated_ffn_kernel(*args, gelu_kind="tanh")  # noqa: E731
    plain_call = lambda: fused_gated_ffn_reference(*args, gelu_kind="tanh")  # noqa: E731
    xla_ffn = xla_ffn_path(torch, layers, args[2], args[3], "tanh")
    with torch.inference_mode():
        torch_call = lambda: xla_ffn(args[0], args[1])  # noqa: E731
        torch_err = (torch_call() - plain_call()).abs().max().item()
        kernel_ms = device_ms(torch, kernel_call)
        plain_ms = device_ms(torch, plain_call)
        torch_ms = device_ms(torch, torch_call)
        kernel_events, plain_events = cuda_ms(torch, kernel_call), cuda_ms(torch, plain_call)
    bound_ms, bound_by = ffn_bound_ms(*args)
    f32_bound_ms, _ = ffn_bound_ms(*args, tensor_cores=False)
    log(f"[ffn] time at [4,1024,256] E=3 5 Linears tanh, weights warm in L2: device time "
        f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms "
        f"({bound_by}, 3xTF32 on the tensor cores), {bound_ms / kernel_ms:.1%} of bound; "
        f"the f32 CUDA-core bound of the earlier kernel {f32_bound_ms:.4f} ms; back-to-back "
        f"calls (CUDA events, host included) kernel {kernel_events:.4f} ms, plain "
        f"{plain_events:.4f} ms on {card}")
    log(f"[ffn] the model's ffn_impl=xla torch path (batched cuBLAS f32 GEMMs) at the same "
        f"shape: device time {torch_ms:.4f} ms ({torch_ms / kernel_ms:.2f}x the kernel's), "
        f"max_abs_err vs the plain version {torch_err:.3e}")
    bf16 = bf16_ffn_phase(torch, np, layers, card, kernel_ms,
                          fused_gated_ffn_kernel, fused_gated_ffn_reference)
    mix = training_mix_ffn_phase(torch, np, card, kernel_ms,
                                 fused_gated_ffn_kernel, fused_gated_ffn_reference)

    # -- phase 3b: the kernel-validation entry point, attention timings --
    attn = attention_phase(torch, torch.device("cuda"), card)

    # -- phase 4: the serving path at full width ------------------------
    argv = ["--serve", "--ffn_impl", "pallas", "--synthetic", "ns2d",
            "--n_test", "16", "--serve_max_batch", "4", "--device", "cuda"]
    serve_args = port_main.build_parser().parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    attn_wrappers = [fused_attention.nla_reduce_kernel, fused_attention.nla_apply_kernel,
                     fused_attention.nla_reduce_seg_kernel, fused_attention.nla_apply_seg_kernel]
    for w in [fused_gated_ffn_kernel, *attn_wrappers]:
        w.launches = 0
    fused_gated_ffn_kernel.launches_by_dtype = {}
    run = port_main.run_serve(serve_args)
    launches = fused_gated_ffn_kernel.launches
    if fused_gated_ffn_kernel.launches_by_dtype != {"f32": launches}:
        raise RuntimeError(f"f32 serving launched {fused_gated_ffn_kernel.launches_by_dtype}")
    log(f"[serve] attention kernel launches {[w.launches for w in attn_wrappers]}: the model "
        "runs attention as torch einsums (attention_impl='pallas' is refused)")
    summary = run.summary
    log(f"[serve] python -m gnot_tpu_torch.main {' '.join(argv)}")
    log(f"[serve] summary {json.dumps(summary)}")
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    n_ok = sum(r.ok for r in run.results)
    if n_ok != len(run.results) or len(run.results) != 16:
        raise RuntimeError(
            f"{n_ok}/{len(run.results)} requests ok: "
            f"{[(r.reason, r.detail) for r in run.results if not r.ok]}"
        )
    cfg = run.model.config
    warmed = summary["warmed_buckets"]
    dispatches = summary["dispatches"] + warmed
    expected = 2 * cfg.n_attn_layers * dispatches
    log(f"[serve] {n_ok}/16 ok; fused_gated_ffn launches {launches} = "
        f"2 x {cfg.n_attn_layers} blocks x {dispatches} dispatches "
        f"({summary['dispatches']} served + {warmed} warm-up)")
    if launches != expected or launches == 0:
        raise RuntimeError(f"expected {expected} FFN kernel launches, counted {launches}")

    # The same weights forward again on the card, every FFN through the
    # kernel's plain version instead of the kernel.
    layers.fused_gated_ffn = fused_gated_ffn_reference
    try:
        plain = InferenceEngine(run.model, batch_size=4).predict(run.samples)
    finally:
        layers.fused_gated_ffn = fused_gated_ffn
    worst = 0.0
    for r, want in zip(run.results, plain):
        if r.output.shape != want.shape or not np.all(np.isfinite(r.output)):
            raise RuntimeError(f"bad served output shape {r.output.shape} vs {want.shape}")
        np.testing.assert_allclose(r.output, want, rtol=MODEL_RTOL, atol=MODEL_ATOL)
        worst = max(worst, float(np.max(np.abs(r.output - want))))
    log(f"[serve] outputs vs a forward through the kernel's plain version on the card: "
        f"max_abs_err {worst:.3e} (tolerance rtol {MODEL_RTOL} atol {MODEL_ATOL})")
    log(f"[serve] request latency p50 {summary['latency_p50_ms']:.3f} ms "
        f"p99 {summary['latency_p99_ms']:.3f} ms; dispatch p50 "
        f"{summary['dispatch_ms_p50']:.3f} ms max {summary['dispatch_ms_max']:.3f} ms "
        f"(host clock); peak device memory {peak_mib:.1f} MiB")

    # -- phase 4b: the serving path in bf16 at full width -----------------
    bf16_launches = bf16_serving_phase(torch, np, port_main, layers, run, peak_mib, card)

    # -- phase 5: where one full-width dispatch spends its time ----------
    plain_model = copy.deepcopy(run.model)
    for m in plain_model.modules():
        if isinstance(m, layers.GatedExpertFfn):
            m.ffn_impl = "xla"
    where_the_time_goes(torch, run.model, plain_model, run.samples[:4], InferenceEngine)

    # -- phase 6: training at full width ----------------------------------
    train_launches, f32_trainer, f32_peak_mib = training_phase(torch, np, card)

    # -- phase 6b: bf16 training at full width ----------------------------
    bf16_trainer, train_bf16_by_mix = bf16_training_phase(torch, np, card, f32_trainer,
                                                          f32_peak_mib)

    # -- phase 6c: remat, then eval, predict and export from 6b -----------
    remat_and_artifacts_phase(torch, np, card, f32_peak_mib, bf16_trainer)

    # -- phase 7: parity training at full width ---------------------------
    parity_launches = parity_training_phase(torch, np, card)

    # -- phase 8: packed serving at full width, f32 and bf16 ---------------
    packed_serve_launches, packed_bf16_launches, packed_fields = packed_serving_phase(
        torch, np, card)

    # -- phase 9: packed training at full width ----------------------------
    packed_train_launches = packed_training_phase(torch, np, card)

    # -- phase 10: accumulation, K steps per dispatch, flat and stacked ----
    loop_launches = training_loop_phase(torch, np, card)

    # -- phase 11: telemetry, tracing, the sink and the profile ------------
    obs_launches = observability_phase(torch, np, card, f32_trainer, train_launches)

    # -- phase 12: recovery, faults, preemption, the checkpointer's chain ---
    resil_launches = resilience_phase(torch, np, card, f32_trainer)

    # -- phase 13: deadlines, the breaker, reload, SIGTERM, live metrics ---
    serve13_launches = serving_policies_phase(torch, np, card, layers)

    # -- phase 14: rollout sessions and tenants ----------------------------
    rollout_launches = rollout_tenants_phase(torch, np, card, layers)

    # -- phase 15: engine replicas and the router ---------------------------
    router_launches = router_phase(torch, np, card, layers)

    # -- phase 16: the program catalog and the autoscaler ------------------
    autoscale_launches = catalog_autoscale_phase(torch, np, card, layers)

    # -- phase 17: the federation and cluster tracing -----------------------
    federation_launches = federation_phase(torch, np, card, layers)

    # -- phase 18: parallel training over torch.distributed ----------------
    par = parallel_phase(torch, np, card)

    # -- phase 19: the pipeline, packed and stacked meshes ------------------
    pipe = pipeline_phase(torch, np, card, par["mesh_of_one"])

    # -- phase 20: the native host packer, the port's lint ------------------
    native_launches = native_phase(torch, np, card, layers)

    # -- phase 21: serving over a rank mesh, parity on a mesh, --changed ----
    mesh_launches = mesh_serving_phase(torch, np, card)

    # -- phase 22: the serving operator's tools on the card host -----------
    tools_launches = tools_phase(torch, np, card, layers)

    # -- phase 23: the reference's scale, long context, bf16 attention ------
    ref = reference_scale_phase(torch, np, card, layers, attn, mix)

    # -- phase 24: the bench and the tools built on it ------------------------
    bench_fields = bench_phase(torch, card)

    # -- phase 25: the overhead and chaos A/B tools ----------------------------
    ab_fields = ab_tools_phase(torch, card)

    # -- phase 26: the open-loop serving load tools ----------------------------
    load_fields = load_tools_phase(torch, np, card, layers)

    kernels = [{
        "name": "fused_gated_ffn",
        "route": "cuda",
        "source": "gnot_tpu_torch/csrc/fused_gated_ffn.cu",
        "replaces": "gnot_tpu/ops/pallas_ffn.py:206",
        "launches": launches,
        "train_launches": train_launches,
        "max_abs_err": max_abs,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "bf16_launches": bf16_launches,
        **bf16,
        "train_bf16_launches": train_bf16_by_mix["bf16-x/f32-w"],
        "launches_by_mix": {"f32": launches, "bf16": bf16_launches,
                            "bf16-x/f32-w": train_bf16_by_mix["bf16-x/f32-w"]},
        **mix,
        "parity_train_launches": parity_launches,
        "packed_serve_launches": packed_serve_launches,
        "packed_serve_bf16_launches": packed_bf16_launches,
        "packed_train_launches": packed_train_launches,
        **packed_fields,
        **loop_launches,
        **obs_launches,
        **resil_launches,
        **serve13_launches,
        **rollout_launches,
        **router_launches,
        **autoscale_launches,
        **federation_launches,
        "mesh_train_launches": pipe["mesh_train_launches"],
        **native_launches,
        **mesh_launches,
        **tools_launches,
        **ref["ffn"],
        **bench_fields,
        **ab_fields,
        **load_fields,
    }]
    replaces = {
        "nla_reduce": "gnot_tpu/ops/pallas_attention.py:206",
        "nla_apply": "gnot_tpu/ops/pallas_attention.py:304",
        "nla_reduce_seg": "gnot_tpu/ops/pallas_attention.py:581",
        "nla_apply_seg": "gnot_tpu/ops/pallas_attention.py:710",
    }
    for name, entry in attn.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "gnot_tpu_torch/csrc/" + ("nla_reduce.cu" if "reduce" in name else "nla_apply.cu"),
            "replaces": replaces[name],
            **entry,
            **ref["attn"][name],
            "library_ms": None,
            **({"sp_launches": par["sp_launches"][name]} if name in par["sp_launches"] else {}),
        })
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_entry(sys.argv[2:]))
    sys.exit(main())
