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
  dispatches.

Each keeps its JAX tool's flags, defaults, importable functions and
returned dicts, and imports only the standard library, numpy, torch and
the port: the readers run on any host that holds the files, the smoke,
the bench tools and the demo on the card unless ``--device cpu`` is
passed.
"""
