"""The port's lint (``gnot_tpu_torch/analysis``) against the JAX package's
(``gnot_tpu/analysis``) on shared fixtures, the port's tree held clean,
and the CLI's exit codes.

Each fixture is a small tree written under ``tmp_path`` from the strings
below (never live code in ``tests/``, which the JAX package's own lint
and lock map scan). Both packages' rule runs over it, configured at the
tree, and must give the same ``(rule, line)`` findings; each rule has at
least one fixture that fires and one that stays silent. GL010 reads
JAX's ``config_from_args`` mapping in the JAX package and the port's
keyword calls in the port, so its fixtures render the same wiring in
both forms, one entry a line, on the same lines.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from gnot_tpu import analysis as jax_analysis
from gnot_tpu_torch import analysis
from gnot_tpu_torch.analysis import __main__ as lint_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_GUARDED = '''
import threading


class Box:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0  #: guarded_by _lock

    def bump(self):
        {body}
'''

_LOCK_PAIR = '''
import threading


class Alpha:
    def __init__(self, other):
        self._lock = threading.Lock()
        self.other = other

    def run_alpha(self):
        with self._lock:
            self.other.poke_beta()

    def poke_alpha(self):
        with self._lock:
            return 1


class Beta:
    def __init__(self, other):
        self._lock = threading.Lock()
        self.other = other

    def run_beta(self):
        {beta_body}

    def poke_beta(self):
        with self._lock:
            return 2
'''

_REENTRY = '''
import threading


class Twice:
    def __init__(self):
        self._lock = threading.{kind}()

    def outer(self):
        with self._lock:
            self.inner()

    def inner(self):
        with self._lock:
            return 3
'''

_BLOCKING = '''
import threading
import time


class Waiter:
    def __init__(self):
        self._lock = threading.Lock()

    def go(self, fut, engine):
        with self._lock:
            {line}
'''

_REGISTRY = '''
EVENTS = {
    "shed": dict(doc="a shed request"),
    "reload": dict(doc="a hot reload"),
}
SPANS = {
    "dispatch": dict(doc="one dispatch"),
}
FAULT_KINDS = (
    "nan_grad",
    "sigterm",
)
MESSAGES = {
    "hello": dict(doc="handshake"),
}
HELLO = "hello"
'''

_EMITTER = '''
def serve(sink, tracer, wire):
    sink.log(event={event!r})
    with tracer.span({span!r}):
        pass
    return wire({message!r}, version=1)
'''

_DOCS = "`shed` `reload` `dispatch` `nan_grad` `sigterm` `hello`\n"

_C_SOURCE = '''
#include <cstdint>
extern "C" {
void gnot_pack_rows(const float** srcs, const int64_t* lens, int64_t n,
                    int64_t dim, float* out);
void gnot_unpad_rows(const char* src, const int64_t* rows, int64_t n,
                     char** dsts);
}
'''

_BINDINGS = '''
import ctypes


def _bind(lib):
    lib.gnot_pack_rows.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_int64,{extra}
        ctypes.c_void_p,
    ]
    lib.gnot_unpad_rows.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.{n_type},
        ctypes.POINTER(ctypes.c_void_p),
    ]
    return lib
'''

_CONFIG = '''
import dataclasses


@dataclasses.dataclass
class TrainConfig:
    epochs: int = 1
    lr: float = 0.001
{extra_field}
'''

_CLI_HEAD = '''
import argparse


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int)
    p.add_argument("--lr", type=float)
    return p


def config_from_args(args):
'''


def _ta_cli(entries, form):
    """The CLI fixture in JAX's mapping form or the port's keyword form:
    one ``(field, value)`` entry a line, the same lines in both."""
    if form == "jax":
        body = ["    return {"] + [f'        "train.{k}": {v},' for k, v in entries] + ["    }"]
    else:
        body = ["    return TrainConfig("] + [f"        {k}={v}," for k, v in entries] + ["    )"]
    return _CLI_HEAD + "\n".join(body) + "\n"


def _ta_config_tree(entries, extra_field="", docs="`epochs` `lr`\n"):
    common = {"cfg.py": _CONFIG.format(extra_field=extra_field), "doc.md": docs}
    return {"jax": {**common, "cli.py": _ta_cli(entries, "jax")},
            "port": {**common, "cli.py": _ta_cli(entries, "port")}}


_WIRED = [("epochs", "args.epochs"), ("lr", "args.lr")]

#: name -> (rule, files, fires). ``files`` is one tree for both packages,
#: or {"jax": tree, "port": tree} where their forms differ (GL010).
FIXTURES = {
    "GL004-outside-lock": ("GL004", {"m.py": _GUARDED.format(body="self._n += 1")}, True),
    "GL004-under-lock": (
        "GL004", {"m.py": _GUARDED.format(body="with self._lock:\n            self._n += 1")},
        False),
    "GL004-suppressed": (
        "GL004",
        {"m.py": _GUARDED.format(
            body="self._n += 1  # graftlint: disable=GL004 — single-threaded here")},
        False),
    "GL005-unknown-kinds": (
        "GL005", {"reg.py": _REGISTRY, "doc.md": _DOCS,
                  "m.py": _EMITTER.format(event="shedd", span="dispach", message="helo")},
        True),
    "GL005-undocumented-entry": (
        "GL005", {"reg.py": _REGISTRY, "doc.md": _DOCS.replace("`sigterm` ", ""),
                  "m.py": _EMITTER.format(event="shed", span="dispatch", message="hello")},
        True),
    "GL005-registered": (
        "GL005", {"reg.py": _REGISTRY, "doc.md": _DOCS,
                  "m.py": _EMITTER.format(event="reload", span="dispatch", message="hello")},
        False),
    "GL007-arity-and-tag-drift": (
        "GL007", {"nat/__init__.py": _BINDINGS.format(extra="", n_type="c_int32"),
                  "nat/pack.cpp": _C_SOURCE}, True),
    "GL007-in-step": (
        "GL007", {"nat/__init__.py": _BINDINGS.format(
            extra="\n        ctypes.c_void_p,", n_type="c_int64"),
                  "nat/pack.cpp": _C_SOURCE.replace("int64_t dim, float* out",
                                                    "int64_t dim, float* out, float* mask")},
        False),
    "GL008-inversion": (
        "GL008", {"m.py": _LOCK_PAIR.format(
            beta_body="with self._lock:\n            self.other.poke_alpha()")}, True),
    "GL008-one-order": (
        "GL008", {"m.py": _LOCK_PAIR.format(beta_body="self.other.poke_alpha()")}, False),
    "GL008-lock-reentered": ("GL008", {"m.py": _REENTRY.format(kind="Lock")}, True),
    "GL008-rlock-reentered": ("GL008", {"m.py": _REENTRY.format(kind="RLock")}, False),
    "GL009-unbounded-waits": (
        "GL009", {"m.py": _BLOCKING.format(
            line="fut.result()\n            time.sleep(0.1)\n            engine.infer([])")},
        True),
    "GL009-unjustified": (
        "GL009", {"m.py": _BLOCKING.format(line="fut.result()  #: allowed_blocking")}, True),
    "GL009-bounded-or-justified": (
        "GL009", {"m.py": _BLOCKING.format(
            line="fut.result(timeout=1.0)\n"
                 "            #: allowed_blocking — the caller owns this wait\n"
                 "            engine.infer([])")},
        False),
    "GL010-drift": (
        "GL010", _ta_config_tree(
            [("epochs", "args.epochs"), ("ghost", "args.lr"), ("lr", "args.learning_rate")],
            extra_field="    warmup: int = 0"),
        True),
    "GL010-undocumented": ("GL010", _ta_config_tree(_WIRED, docs="`epochs`\n"), True),
    "GL010-wired": ("GL010", _ta_config_tree(_WIRED), False),
}

#: The knobs that point each package's rules at a fixture tree. The port
#: takes a list of docs where JAX takes one file.
_JAX_KNOBS = dict(
    events_registry="reg.py", faults_registry="reg.py", messages_registry="reg.py",
    docs_events="doc.md", docs_faults="doc.md", docs_messages="doc.md",
    native_binding="nat/__init__.py", native_source="nat/pack.cpp",
    config_module="cfg.py", cli_module="cli.py", config_sections=["train:TrainConfig"],
    docs_config=["doc.md"],
)
_PORT_KNOBS = dict(_JAX_KNOBS, docs_events=["doc.md"], docs_faults=["doc.md"],
                   docs_messages=["doc.md"], config_unwired=[])


def _ta_write(root, files):
    for rel, text in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(textwrap.dedent(text).lstrip("\n") if rel.endswith(".py") else text)


def _ta_findings(package, root, rule, knobs):
    cfg = package.LintConfig(enable=[rule], paths=["."], exclude=[], **knobs)
    findings, _ = package.run_analysis(["."], root=str(root), config=cfg)
    return sorted((f.rule, f.path, f.line) for f in findings)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_rule_gives_jax_s_findings(name, tmp_path):
    rule, files, fires = FIXTURES[name]
    trees = files if set(files) == {"jax", "port"} else {"jax": files, "port": files}
    _ta_write(tmp_path / "jax", trees["jax"])
    _ta_write(tmp_path / "port", trees["port"])
    want = _ta_findings(jax_analysis, tmp_path / "jax", rule, _JAX_KNOBS)
    got = _ta_findings(analysis, tmp_path / "port", rule, _PORT_KNOBS)
    assert got == want
    assert bool(got) == fires, got


def test_config_drift_reads_the_keyword_form(tmp_path):
    """GL010 on the port's keyword calls: a field with no keyword, an
    unknown keyword and an undeclared ``args.<flag>`` each fire where
    they are; a field named in ``config_unwired`` is not reported unwired."""
    entries = [("epochs", "args.epochs"), ("ghost", "args.lr"), ("lr", "args.learning_rate")]
    _ta_write(tmp_path, _ta_config_tree(entries, extra_field="    warmup: int = 0",
                                        docs="`epochs` `lr` `warmup`\n")["port"])
    knobs = dict(_PORT_KNOBS, config_unwired=[])
    cfg = analysis.LintConfig(enable=["GL010"], paths=["."], **knobs)
    found = {(f.path, f.line, f.message.split(" (")[0])
             for f in analysis.run_analysis(["."], root=str(tmp_path), config=cfg)[0]}
    assert found == {
        ("cfg.py", 8, "config field train.warmup has no CLI wiring in cli.py"),
        ("cli.py", 14, "config keyword 'train.ghost' does not match any field of the "
                       "configured dataclasses in cfg.py"),
        ("cli.py", 15, "TrainConfig(lr=...) reads args.learning_rate but no "
                       "--learning_rate flag is declared"),
    }
    cfg.config_unwired = ["train.warmup"]
    lines = [f.line for f in analysis.run_analysis(["."], root=str(tmp_path), config=cfg)[0]]
    assert lines == [14, 15]


def test_native_abi_fires_on_a_drifted_copy_of_the_port(tmp_path):
    """GL007 over a copy of the port's native/ with one argtypes entry of
    gnot_pack_rows_bf16 dropped: both packages' rule report the arity drift."""
    src = os.path.join(ROOT, "gnot_tpu_torch", "native")
    shutil.copytree(src, tmp_path / "nat", ignore=shutil.ignore_patterns("__pycache__"))
    path = tmp_path / "nat" / "__init__.py"
    text = path.read_text()
    head, sep, tail = text.partition("lib.gnot_pack_rows_bf16.argtypes = [\n")
    tail = tail.replace("        ctypes.c_void_p,\n", "", 1)
    path.write_text(head + sep + tail)
    knobs = dict(native_source="nat/ragged_pack.cpp", native_binding="nat/__init__.py")
    want = _ta_findings(jax_analysis, tmp_path, "GL007", knobs)
    got = _ta_findings(analysis, tmp_path, "GL007", knobs)
    assert got == want and len(got) == 1, got
    line = text[: text.index("lib.gnot_pack_rows_bf16.argtypes")].count("\n") + 1
    assert got == [("GL007", "nat/__init__.py", line)]


@pytest.fixture(scope="module")
def port_lint():
    """One run of every rule over the port's default paths."""
    cfg = analysis.LintConfig()
    return analysis.run_analysis(cfg.paths, root=ROOT, config=cfg)


def test_port_tree_is_clean(port_lint):
    """Zero findings over gnot_tpu_torch/ and chip_smoke.py, every ported
    rule on, each suppression in the tree carrying its reason."""
    findings, stats = port_lint
    assert stats["rules"] == ["GL004", "GL005", "GL007", "GL008", "GL009", "GL010"]
    assert stats["files"] > 60
    assert findings == [], "\n".join(f.format() for f in findings)
    assert stats["suppressed"] >= 2  # server.py's two GL004 lines, with reasons


@pytest.mark.parametrize("argv, code", [
    (["{clean}"], 0),
    (["{clean}", "--rules", "GL004,GL009", "--format", "json"], 0),
    (["{dirty}"], 1),
    (["{dirty}", "--rules", "GL009"], 0),
    (["--rules", "GL001"], 2),
    (["no_such_file.py"], 2),
    (["--format", "yaml"], 2),
], ids=["clean", "clean-json", "findings", "other-rule", "unported-rule", "no-path",
        "bad-flag"])
def test_cli_exit_codes(argv, code, tmp_path, capsys):
    _ta_write(tmp_path, {"clean.py": _GUARDED.format(
        body="with self._lock:\n            self._n += 1"),
        "dirty.py": _GUARDED.format(body="self._n += 1")})
    argv = [a.format(clean="clean.py", dirty="dirty.py") for a in argv]
    assert lint_cli.main(["--root", str(tmp_path), *argv]) == code
    out = capsys.readouterr().out
    if "json" in argv:
        assert json.loads(out)["findings"] == []


def test_module_entry_point(tmp_path):
    """``python -m gnot_tpu_torch.analysis`` runs the same CLI."""
    _ta_write(tmp_path, {"dirty.py": _GUARDED.format(body="self._n += 1")})
    out = subprocess.run(
        [sys.executable, "-m", "gnot_tpu_torch.analysis", "--root", str(tmp_path),
         "dirty.py", "--format", "json"],
        cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert out.returncode == 1, out.stderr
    (finding,) = json.loads(out.stdout)["findings"]
    assert (finding["rule"], finding["path"], finding["line"]) == ("GL004", "dirty.py", 10)


# -- --changed and --update-baseline against tools/lint.py's on one repository --


def _git(root, *args):
    subprocess.run(["git", "-c", "user.email=t@t", "-c", "user.name=t", *args],
                   cwd=root, check=True, capture_output=True, timeout=60)


def _jax_lint_main():
    """``tools/lint.py``'s main(), loaded in-process."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("gnot_lint_cli",
                                                  os.path.join(ROOT, "tools", "lint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _fixture_repo(root, rule, files):
    """A git repository at ``root`` whose lint roots are ``gnot_tpu_torch``
    for both tools (JAX's through its pyproject section, the port's by
    default), ``files`` committed as its first commit."""
    enable = ", ".join(f'"{r}"' for r in rule.split(","))
    _ta_write(root, {"pyproject.toml": f'[tool.graftlint]\nenable = [{enable}]\n'
                                       'paths = ["gnot_tpu_torch"]\n', **files})
    _git(root, "init", "-q")
    _git(root, "add", "-A")
    _git(root, "commit", "-qm", "seed")


def _both(root, rule, *argv, capsys):
    """The exit codes and outputs of ``tools/lint.py`` and of the port's
    CLI, one after the other, on the repository at ``root``."""
    jax_rc = _jax_lint_main()([*argv, "--root", str(root)])
    jax_out = capsys.readouterr().out
    port_rc = lint_cli.main([*argv, "--root", str(root), "--rules", rule])
    return (jax_rc, port_rc), (jax_out, capsys.readouterr().out)


def test_changed_mode_scopes_the_report_and_baselines_per_rule_and_path(tmp_path, capsys):
    """``--changed`` reports only changed files under the lint roots; the
    baseline (written by ``--update-baseline`` from a full run) masks its
    findings counted per ``(rule, path)``, so a new finding beyond the
    count fails: at every step the port's CLI exits as ``tools/lint.py``
    does on the same repository (``tests/test_analysis.py:1045-1088``)."""
    bad = _GUARDED.format(body="self._n += 1")
    _fixture_repo(tmp_path, "GL004", {"gnot_tpu_torch/mod.py": "x = 1\n", "scratch.py": bad})
    rcs, outs = _both(tmp_path, "GL004", "--changed", capsys=capsys)
    assert rcs == (0, 0) and all("no changes vs HEAD" in o for o in outs)
    # A violation outside the lint roots is not gated.
    _ta_write(tmp_path, {"scratch.py": bad + "\n# touched\n"})
    assert _both(tmp_path, "GL004", "--changed", capsys=capsys)[0] == (0, 0)
    # One in a changed file under the roots fails...
    _ta_write(tmp_path, {"gnot_tpu_torch/mod.py": bad})
    rcs, outs = _both(tmp_path, "GL004", "--changed", capsys=capsys)
    assert rcs == (1, 1) and all("gnot_tpu_torch/mod.py:10: GL004" in o for o in outs)
    # ...unless the baseline tolerates it...
    os.makedirs(tmp_path / "tools")
    assert _both(tmp_path, "GL004", "--update-baseline", capsys=capsys)[0] == (0, 0)
    baseline = json.load(open(tmp_path / lint_cli.BASELINE_PATH))
    assert [(f["rule"], f["path"]) for f in baseline["findings"]] == [
        ("GL004", "gnot_tpu_torch/mod.py")]
    rcs, outs = _both(tmp_path, "GL004", "--changed", capsys=capsys)
    assert rcs == (0, 0) and all("1 baseline-masked" in o for o in outs)
    # ...also when edits move it to another line...
    _ta_write(tmp_path, {"gnot_tpu_torch/mod.py": "# moved\n\n" + bad})
    assert _both(tmp_path, "GL004", "--changed", capsys=capsys)[0] == (0, 0)
    # ...and a new finding beyond the baseline's count still fails.
    _ta_write(tmp_path, {"gnot_tpu_torch/mod.py": bad + "\n" + bad.replace("class Box",
                                                                             "class Box2")})
    rcs, outs = _both(tmp_path, "GL004", "--changed", "--format", "json", capsys=capsys)
    assert rcs == (1, 1)
    for out in outs:
        stats = json.loads(out)["stats"]
        assert (stats["findings"], stats["baseline_masked"]) == (1, 1)
    # Paths with --changed are a usage error, as in tools/lint.py.
    assert _both(tmp_path, "GL004", "--changed", "gnot_tpu_torch", capsys=capsys)[0] == (2, 2)


def test_changed_mode_keeps_the_cross_file_analysis(tmp_path, capsys):
    """``--changed`` scopes the report, not the analysis: an edit to one
    class that inverts the lock order another, unchanged file holds is
    found (the cross-file pass reads every root), while an unchanged
    file's own per-file finding stays out of the report; both tools
    agree (``tests/test_analysis.py:1120-1140``)."""
    alpha, beta = _LOCK_PAIR.split("\n\nclass Beta")
    beta = "import threading\n\n\nclass Beta" + beta
    rules = "GL004,GL008"
    _fixture_repo(tmp_path, rules, {
        "gnot_tpu_torch/alpha.py": alpha,
        "gnot_tpu_torch/beta.py": beta.format(beta_body="self.other.poke_alpha()"),
        "gnot_tpu_torch/old.py": _GUARDED.format(body="self._n += 1")})
    assert lint_cli.main(["--root", str(tmp_path), "--rules", rules]) == 1
    assert "old.py:10: GL004" in capsys.readouterr().out
    assert _both(tmp_path, rules, "--changed", capsys=capsys)[0] == (0, 0)
    _ta_write(tmp_path, {"gnot_tpu_torch/beta.py": beta.format(
        beta_body="with self._lock:\n            self.other.poke_alpha()")})
    rcs, outs = _both(tmp_path, rules, "--changed", capsys=capsys)
    assert rcs == (1, 1)
    for out in outs:
        assert "GL008" in out and "alpha.py" in out and "old.py" not in out


def test_changed_mode_reports_project_findings_for_a_doc_edit(tmp_path, capsys):
    """A docs-only edit can cause a registry/docs drift finding (GL005,
    project-level): ``--changed`` reports it though no ``.py`` changed
    (``tests/test_analysis.py:1090-1118``); without git it falls back to a
    full run."""
    files = {f"gnot_tpu_torch/{p}": _REGISTRY for p in (
        "obs/events.py", "resilience/faults.py", "serve/federation.py")}
    files.update({"gnot_tpu_torch/mod.py": "x = 1\n", "docs/observability.md": _DOCS,
                  "docs/robustness.md": _DOCS, "docs/distributed.md": _DOCS,
                  "README.md": ""})
    _fixture_repo(tmp_path, "GL005", files)
    assert lint_cli.main(["--changed", "--root", str(tmp_path), "--rules", "GL005"]) == 0
    capsys.readouterr()
    _ta_write(tmp_path, {"docs/observability.md": _DOCS.replace("`reload` ", "")})
    assert lint_cli.main(["--changed", "--root", str(tmp_path), "--rules", "GL005"]) == 1
    assert "reload" in capsys.readouterr().out
    shutil.rmtree(tmp_path / ".git")
    assert lint_cli.main(["--changed", "--root", str(tmp_path), "--rules", "GL005"]) == 1
    assert "git unavailable; falling back to a full run" in capsys.readouterr().err
