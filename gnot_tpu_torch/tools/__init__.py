"""The operator's tools of the port, one module for each of the repo's
``tools/`` scripts that reads or drives serving, the reference-scale
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
  byte-identical across two runs.

Each keeps its JAX tool's flags, defaults, importable functions and
returned dicts or records, and imports only the standard library, numpy,
torch and the port: the readers run on any host that holds the files, the
smoke, the bench tools, the demo and the A/Bs on the card unless
``--device cpu`` is passed. The A/Bs report the JAX package's 2% overhead
bars and assert none; the chaos A/Bs assert their correctness bars
(``failures``, exit 1).
"""
