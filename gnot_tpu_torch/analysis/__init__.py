"""The port's static analysis: the JAX package's lint rules that have a
torch subject, over ``gnot_tpu_torch/`` and ``chip_smoke.py``.

Ported (``gnot_tpu/analysis/``'s rules, same ids, same findings on the
same source):

* **GL004** lock discipline: a ``#: guarded_by <lock>`` field touched
  outside ``with self.<lock>`` (``locks.py``);
* **GL005** registry drift: event, span, fault and wire kinds against
  the port's four registries and their docs (``registry_drift.py``);
* **GL007** native ABI drift: the ctypes ``argtypes`` in
  ``native/__init__.py`` against ``ragged_pack.cpp``'s ``extern "C"``
  declarations (``native_abi.py``);
* **GL008** lock-order inversion over the project-wide
  acquires-while-holding graph and **GL009** blocking calls under a held
  lock, justified with ``#: allowed_blocking — reason``
  (``lockorder.py``);
* **GL010** config drift: the config dataclasses against the keyword
  calls that build them in ``main.py``, the declared flags and the docs
  (``config_drift.py``).

Not ported, by name, because they have no torch subject: **GL001**
(use after buffer donation) and **GL006** (donation through helper
wrappers) — eager PyTorch donates no buffers; **GL002** (host sync in
a jit-compiled step body) and **GL003** (recompile hazards) — the port
has no jit trace. Nor ``tools/lint.py``'s ``--changed`` mode and its
baseline file, which wait (``ROADMAP.md``).

Stdlib only (``ast`` + ``re``): the analysis never imports the code it
reads. Usage: ``python -m gnot_tpu_torch.analysis [paths] [--rules
GL004,GL009] [--format json]``; exit 0 clean, 1 findings, 2 usage.
``# graftlint: disable=RULE — reason`` suppresses one line.
"""

from gnot_tpu_torch.analysis.core import (  # noqa: F401
    Finding,
    LintConfig,
    Rule,
    RULES,
    register,
    run_analysis,
)

# Importing the rule modules registers them.
from gnot_tpu_torch.analysis import config_drift  # noqa: F401
from gnot_tpu_torch.analysis import lockorder  # noqa: F401
from gnot_tpu_torch.analysis import locks  # noqa: F401
from gnot_tpu_torch.analysis import native_abi  # noqa: F401
from gnot_tpu_torch.analysis import registry_drift  # noqa: F401
