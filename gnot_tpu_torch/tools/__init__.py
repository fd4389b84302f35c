"""The operator's tools of the port, one module for each of the repo's
``tools/`` scripts that reads, drives or loads serving, the reference-scale
training demo and the three tools built on the bench
(``gnot_tpu_torch/bench.py``), under the same name, each run as ``python -m
gnot_tpu_torch.tools.<name>``:

* ``trace_report``: a ``--trace_path`` Chrome trace's per-kind, per-bucket,
  per-replica, per-tenant and per-host tables and the critical path;
* ``metrics_report``: the ``--metrics_interval_s`` series, its SLO breach
  intervals and the final snapshot against ``serve_summary``;
* ``serve_smoke``: the serving smoke with asserted counters, in every mode
  of ``tools/serve_smoke.py``;
* ``capacity_report``: a ``--capacity`` storm folded into program,
  capacity and pack-plan rows;
* ``lockmap_report``: the port's lock graph (``analysis/lockorder.py``) as
  node, edge and summary records;
* ``reference_scale_demo``: reference-scale pickles (~10k-point meshes) and
  a ``--train_data`` run on them with its throughput summary;
* ``honest_probe``: the bench's marginal ms a step for an ad-hoc config;
* ``profile_step``: the bench step's device records under
  ``torch.profiler``, by kernel family;
* ``pack_ab``: padded against packed, the bench's train step and the
  smoke's serving storm, with the packed outputs held to their solo
  dispatches;

and the overhead and chaos A/Bs, each two arms over identical work:

* ``telemetry_ab``: train step ms, telemetry off against on (the
  instrumented step, a ``TelemetryBuffer`` draining into a sink);
* ``tracing_ab``: train step ms, span tracing off against on (the
  trainer's span sites, the flush inside the window);
* ``metrics_ab``: serve-storm requests/s, the live metrics plane off
  against on (registry, publisher thread, SLO evaluator);
* ``capacity_ab``: serve-storm requests/s, catalog attribution off against
  on, the metrics plane on in both arms;
* ``dtrace_ab``: federated ms a request, cluster tracing and flight
  recorders off against on;
* ``rollout_ab``: replica 0 killed mid-storm; session migration loses no
  session, its no-migration twin loses some, served rollouts within 1e-5
  of ``offline_rollout``;
* ``federation_ab``: the owner host killed; re-migration loses no session,
  the no-failover twin loses some, and the single-host path is
  byte-identical across two runs;

and the open-loop serving load, arrivals on a seeded schedule whether or
not the pool keeps up:

* ``loadgen``: the seeded traces (steady, diurnal, bursty, multi-tenant)
  and their open-loop replay, bitwise ``tools/loadgen.py``'s (numpy only);
* ``serve_bench``: 1 against N replicas on an offered-load ladder,
  sustained requests/s at a p99 SLO, replicated outputs against a solo
  engine;
* ``lowprec_ab``: f32 against bf16 serving (a trained model's parity, the
  replica tier's throughput, a device microbench) and the native packer's
  host phases against numpy's;
* ``tenant_ab``: a batch flood beside interactive traffic, the tenant
  plane's WFQ and quotas against the open pool, and the default-path pin;
* ``autoscale_ab``: a static pool against an autoscaled one on a diurnal
  trace, and a scale-in whose retiring replica is killed under sessions.

Each keeps its JAX tool's flags, defaults, importable functions and
returned dicts or records, and imports only the standard library, numpy,
torch and the port: the readers run on any host that holds the files, the
smoke, the bench tools, the demo and the A/Bs on the card unless
``--device cpu`` is passed. The A/Bs report the JAX package's 2% overhead
bars and assert none; the chaos A/Bs assert their correctness bars
(``failures``, exit 1). The load tools run on the CPU as::

    python -m gnot_tpu_torch.tools.serve_bench --device cpu --quick --out build/serve_bench.jsonl

(``lowprec_ab``, ``tenant_ab``, ``autoscale_ab`` alike), each ``main``
with its JAX twin's exit rule. On the card ``chip_smoke.py``'s phase 26
runs the four at ``--quick`` through ``run()``, each in a process of its
own without JAX, and asserts their correctness bars (replicated vs solo,
bf16 parity, no interactive shed, no lost session or request); it
reports their capacity bars (sustained rates, p99 under an SLO set from
one idle dispatch, saved replica-seconds, the packer's gain, and
``serve_bench``'s 2.5x speedup, a bar for N devices): the port's replicas
are threads sharing one card and one host, and ``serve_bench --trace_path``
shows each replica's host-bound dispatch stretched by the others (about 3x
with 2 replicas, 10x with 4 on an H100).
"""
