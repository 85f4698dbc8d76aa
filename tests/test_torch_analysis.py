"""The port's analyzer (deeplearning4j_tpu_torch/analysis) analyzed, on
the CPU: the catalog and its JAX-to-port table, the shipped tree clean
against tools/analyze_torch_baseline.json, each port rule's bad fixture
at its exact (rule, line, symbol) and the clean fixture silent, the
baseline round trip, stale entries and multiplicity, pragmas, the CLI
in a bare interpreter, the program lint's fixtures and every
programs.py family (clean at CPU widths, its bad counterpart firing),
the three lint_records, and the LockOrderSanitizer drills."""

import dataclasses
import importlib.util
import json
import os
import queue
import runpy
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.analysis import (
    RULES,
    Baseline,
    LockOrderSanitizer,
    analyze,
    program_lint,
    programs,
    sanitizers,
)
from deeplearning4j_tpu_torch.analysis import findings as findings_mod
from deeplearning4j_tpu_torch.analysis.concurrency_lint import (
    run_with_catalog,
)
from deeplearning4j_tpu_torch.analysis.findings import (
    JAX_RULE_IDS,
    JAX_RULE_MAP,
    port_rule_id,
)
from deeplearning4j_tpu_torch.analysis.program_lint import (
    REGISTERED_PROGRAM_RULES,
)
from deeplearning4j_tpu_torch.analysis.source import load_sources

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "deeplearning4j_tpu_torch"
TESTS = ROOT / "tests"
BASELINE = ROOT / "tools" / "analyze_torch_baseline.json"
CLI = ROOT / "tools" / "analyze_torch.py"
CASES = TESTS / "fixtures" / "torch" / "analysis_cases"
BAD, CLEAN, PROGRAMS_FIX = CASES / "bad", CASES / "clean", CASES / "programs"


# ==================================================== rule catalog
def test_catalog_maps_every_jax_rule_to_a_port_rule():
    for jid in JAX_RULE_IDS:
        assert port_rule_id(jid) in RULES, jid
    # replaced ids are gone from the catalog, their replacements named
    # in the module's table beside them
    doc = findings_mod.__doc__
    for jid, pid in JAX_RULE_MAP.items():
        assert jid not in RULES and pid in RULES
        line = next(ln for ln in doc.splitlines() if jid in ln)
        assert pid in line, (jid, pid)
    assert len(RULES) == len(JAX_RULE_IDS)
    by_pass = {}
    for r in RULES.values():
        by_pass.setdefault(r.pass_name, []).append(r.id)
        assert r.description
    assert set(by_pass) == {"jit", "concurrency", "conformance",
                            "program", "runtime"}
    assert {"san-lock-order-cycle", "san-long-held-lock"} <= set(RULES)


def test_program_rules_are_the_pinned_registry():
    progs = {r.id for r in RULES.values() if r.pass_name == "program"}
    assert progs == set(REGISTERED_PROGRAM_RULES)
    assert progs == {jid for jid in JAX_RULE_IDS if jid.startswith("prog-")}


# ============================================== tier-1: tree is clean
def test_shipped_tree_clean_vs_baseline():
    """THE gate: a new violation anywhere in the port fails this test
    with the same file:line report the CLI prints; every baseline entry
    carries its reason and none is stale."""
    baseline = Baseline.load(BASELINE)
    res = analyze(PKG, root=ROOT, tests_dir=TESTS, baseline=baseline,
                  test_glob="test_torch_*.py")
    assert res.clean, "new findings:\n" + "\n".join(
        f.render() for f in res.new)
    assert not res.stale, [f"{e['rule']}@{e['file']}" for e in res.stale]
    assert res.files_scanned > 100
    assert all(e.get("reason") for e in baseline.entries)


# ==================================================== true positives
EXPECTED_BAD = {
    ("graph-per-call-key", 21, "StepProgram.group_key"),
    ("graph-uncapturable-op", 26, "StepProgram._group_body"),
    ("graph-uncapturable-op", 27, "StepProgram._group_body"),
    ("graph-uncapturable-op", 33, "_scale"),
    ("graph-read-after-replay", 41, "Runner.run"),
    ("jit-host-sync", 46, "fit"),
    ("jit-host-sync", 47, "fit"),
    ("jit-host-sync", 48, "fit"),
    ("jit-host-sync", 49, "fit"),
}


def _bad_findings():
    return analyze(BAD, root=ROOT, tests_dir=None).findings


def test_bad_fixture_fires_at_exact_rule_line_symbol():
    got = {(f.rule, f.line, f.symbol) for f in _bad_findings()}
    assert got == EXPECTED_BAD, got ^ EXPECTED_BAD


@pytest.mark.parametrize("rule", sorted({r for r, _, _ in EXPECTED_BAD}))
def test_each_port_jit_rule_fires(rule):
    hits = [f for f in _bad_findings() if f.rule == rule]
    assert hits and all(f.file.endswith("bad_graph.py") for f in hits)
    assert all(str(f.line) not in f.message for f in hits)


def test_clean_fixture_no_findings():
    res = analyze(CLEAN, root=ROOT, tests_dir=None)
    assert res.findings == [], [f.render() for f in res.findings]


# ============================================= baseline round-trip
def test_baseline_round_trip(tmp_path):
    finds = _bad_findings()
    path = tmp_path / "bl.json"
    Baseline.from_findings(finds, {finds[0].fingerprint(): "why"}).save(path)
    bl = Baseline.load(path)
    res = analyze(BAD, root=ROOT, tests_dir=None, baseline=bl)
    assert res.clean and len(res.suppressed) == len(finds)
    assert not res.stale
    data = json.loads(path.read_text())
    assert all("fingerprint" in e for e in data["suppressions"])
    assert bl.reasons() == {finds[0].fingerprint(): "why"}


def test_baseline_reports_stale_entries():
    bl = Baseline.from_findings(_bad_findings())
    bl.entries.append({"rule": "graph-uncapturable-op",
                       "file": "deeplearning4j_tpu_torch/ghost.py",
                       "line": 1, "symbol": "gone",
                       "message": "fixed long ago",
                       "fingerprint": "0000000000000000"})
    res = analyze(BAD, root=ROOT, tests_dir=None, baseline=bl)
    assert res.clean and len(res.stale) == 1
    assert res.stale[0]["fingerprint"] == "0000000000000000"


def test_baseline_multiplicity(tmp_path):
    pkg = tmp_path / "minipkg"
    pkg.mkdir()
    (pkg / "mod.py").write_text(textwrap.dedent("""\
        import threading

        def start_two():
            threading.Thread(target=print, daemon=True).start()
            threading.Thread(target=print, daemon=True).start()
    """))
    finds = analyze(pkg, root=tmp_path, tests_dir=None).findings
    unnamed = [f for f in finds if f.rule == "thr-unnamed-thread"]
    assert len(unnamed) == 2
    assert unnamed[0].fingerprint() == unnamed[1].fingerprint()
    bl = Baseline.from_findings([unnamed[0]])
    res = analyze(pkg, root=tmp_path, tests_dir=None, baseline=bl)
    assert any(f.rule == "thr-unnamed-thread" for f in res.new)


# ================================================ pragma suppression
def test_pragma_suppresses_rule(tmp_path):
    pkg = tmp_path / "minipkg"
    pkg.mkdir()
    (pkg / "mod.py").write_text(textwrap.dedent("""\
        import threading

        def fit(x):
            # analyze: allow=jit-host-sync — the drill's one read
            y = x.cpu()
            # analyze: allow=thr-unnamed-thread,thr-orphan-thread — drill
            t = threading.Thread(target=print, daemon=True)
            t.start()
            return y, x.numpy()
    """))
    res = analyze(pkg, root=tmp_path, tests_dir=None)
    got = {(f.rule, f.line) for f in res.findings}
    assert got == {("jit-host-sync", 9)}, got


# ======================================================== CLI contract
def test_cli_bare_interpreter_clean_without_torch_or_jax():
    """`python tools/analyze_torch.py` exits 0 on the shipped tree with
    neither torch nor jax imported (the AST modes' contract)."""
    code = (
        "import runpy, sys, time\n"
        "sys.argv = ['analyze_torch.py']\n"
        "t0 = time.perf_counter()\n"
        "rc = 0\n"
        "try:\n"
        "    runpy.run_path(r'%s', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code or 0\n"
        "bad = [m for m in ('torch', 'jax', 'numpy') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('seconds', time.perf_counter() - t0)\n"
        "sys.exit(rc)\n" % CLI)
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "0 new finding(s)" in p.stdout


def test_cli_rules_diff_and_usage():
    p = subprocess.run([sys.executable, str(CLI), "--rules"], cwd=ROOT,
                       capture_output=True, text=True, timeout=60)
    assert p.returncode == 0
    for rule in RULES:
        assert rule in p.stdout
    for jid, pid in JAX_RULE_MAP.items():
        assert f"JAX {jid} -> {pid}" in p.stdout
    p = subprocess.run([sys.executable, str(CLI), "--diff"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
    p = subprocess.run([sys.executable, str(CLI), "--passes", "nope"],
                       cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert p.returncode == 2


def test_cli_exits_1_on_new_findings(tmp_path):
    """A finding no baseline holds fails the run (exit 1)."""
    pkg = tmp_path / "deeplearning4j_tpu_torch"
    pkg.mkdir()
    (pkg / "mod.py").write_text(textwrap.dedent("""\
        def fit(x):
            return x.cpu()
    """))
    p = subprocess.run([sys.executable, str(CLI), "--root", str(tmp_path)],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 1, p.stdout + p.stderr
    assert "jit-host-sync" in p.stdout and "1 new finding(s)" in p.stdout


# ================================================= thread/lock catalog
def test_concurrency_catalog_of_the_port():
    sources = load_sources(PKG, ROOT)
    _, catalog = run_with_catalog(sources)
    names = {t.name_literal for t in catalog.threads if t.name_literal}
    assert "ParallelInference-batcher" in names
    assert all(t.named and t.daemon for t in catalog.threads)
    assert {lk.kind for lk in catalog.locks} >= {"Lock", "RLock",
                                                 "Condition"}


# ==================================================== reachability
def test_engine_roots_and_captured_body_reach():
    from deeplearning4j_tpu_torch.analysis.jit_lint import (
        ROOT_QUALNAMES,
        build_captured,
        build_reachable,
    )

    sources = load_sources(PKG, ROOT)
    seen = build_reachable(sources)
    for qual in sorted(ROOT_QUALNAMES):
        assert qual in seen, qual
    assert ("deeplearning4j_tpu_torch/engine/step_program.py::"
            "StepProgram._captured") in seen
    cap = build_captured(sources)
    for q in ("engine/step_program.py::StepProgram._group_body",
              "nn/base_network.py::BaseNetwork._step",
              "nn/base_network.py::BaseNetwork._grads",
              "engine/sharding.py::build_zero1_step.step"):
        assert f"deeplearning4j_tpu_torch/{q}" in cap, q
    # the walk stays in the modules the train step runs
    assert not [q for q in cap if "/serving/" in q or "/clustering/" in q]


# ========================================== runtime: LockOrderSanitizer
@pytest.fixture()
def _no_session_sanitizer():
    if sanitizers.active_sanitizer() is not None \
            or "locks" in os.environ.get(sanitizers.ENV_VAR, ""):
        pytest.skip("a session lock sanitizer is active")
    yield


def _run_threads(*pairs):
    for fn, name in pairs:
        t = threading.Thread(target=fn, name=name, daemon=True)
        t.start()
        t.join(timeout=10.0)
        assert not t.is_alive()


@pytest.mark.usefixtures("_no_session_sanitizer")
def test_lock_order_cycle_detected_across_two_threads():
    san = LockOrderSanitizer(long_hold_s=30.0).install()
    try:
        lock_a = threading.Lock()
        lock_b = threading.Lock()

        def a_then_b():
            with lock_a:
                with lock_b:
                    pass

        def b_then_a():
            with lock_b:
                with lock_a:
                    pass

        _run_threads((a_then_b, "drill-ab"), (b_then_a, "drill-ba"))
        cycles = san.cycles()
        assert cycles, san.edges()
        sites = {s for c in cycles for s in c}
        assert len(sites) == 2
        assert all("test_torch_analysis.py" in s for s in sites)
        assert any(v["rule"] == "san-lock-order-cycle"
                   for v in san.violations())
        assert {"drill-ab", "drill-ba"} <= {e.thread for e in san.edges()}
    finally:
        san.uninstall()


@pytest.mark.usefixtures("_no_session_sanitizer")
def test_lock_order_no_false_cycle_on_consistent_order():
    san = LockOrderSanitizer().install()
    try:
        lock_a = threading.Lock()
        lock_b = threading.Lock()
        for _ in range(3):
            with lock_a:
                with lock_b:
                    pass
        assert san.cycles() == [] and len(san.edges()) == 1
    finally:
        san.uninstall()


@pytest.mark.usefixtures("_no_session_sanitizer")
def test_rlock_reentry_is_not_a_self_edge():
    san = LockOrderSanitizer().install()
    try:
        r = threading.RLock()
        with r:
            with r:
                pass
        assert san.edges() == []
        cond = threading.Condition()
        with cond:
            cond.notify_all()
    finally:
        san.uninstall()


@pytest.mark.usefixtures("_no_session_sanitizer")
def test_long_held_lock_flagged():
    san = LockOrderSanitizer(long_hold_s=0.05).install()
    try:
        lk = threading.Lock()
        with lk:
            time.sleep(0.12)
        holds = san.long_holds()
        assert holds and holds[0].duration_s >= 0.05
        assert any(v["rule"] == "san-long-held-lock"
                   for v in san.violations())
    finally:
        san.uninstall()


@pytest.mark.usefixtures("_no_session_sanitizer")
def test_queue_handoff_cycle_detected():
    san = LockOrderSanitizer(long_hold_s=30.0).install()
    try:
        q = queue.Queue(maxsize=4)
        lock = threading.Lock()

        def producer():
            with lock:
                q.put("item")

        def consumer():
            q.get()
            with lock:
                pass

        _run_threads((producer, "q-prod"), (consumer, "q-cons"))
        cycles = san.cycles()
        assert cycles, san.edges()
        assert any(s.startswith("q:") for c in cycles for s in c)
    finally:
        san.uninstall()


@pytest.mark.usefixtures("_no_session_sanitizer")
def test_queue_nonblocking_and_unbounded_ops_make_no_producer_edge():
    san = LockOrderSanitizer().install()
    try:
        lock = threading.Lock()
        q_unbounded = queue.Queue()

        def producer():
            with lock:
                q_unbounded.put("x")

        def consumer():
            q_unbounded.get()
            with lock:
                pass

        _run_threads((producer, "q-fp"), (consumer, "q-fp2"))
        assert san.cycles() == []
        san.reset()
        q_bounded = queue.Queue(maxsize=2)
        with lock:
            q_bounded.put_nowait(1)
        q_bounded.get_nowait()
        assert all(not e.src.startswith("q:") and not e.dst.startswith("q:")
                   for e in san.edges())
    finally:
        san.uninstall()


@pytest.mark.usefixtures("_no_session_sanitizer")
def test_uninstall_restores_real_locks_and_env_gating(monkeypatch):
    san = LockOrderSanitizer().install()
    assert threading.Lock is not sanitizers._REAL_LOCK
    san.uninstall()
    assert threading.Lock is sanitizers._REAL_LOCK
    assert threading.RLock is sanitizers._REAL_RLOCK
    assert queue.Queue.put is sanitizers._REAL_Q_PUT
    assert sanitizers.active_sanitizer() is None
    monkeypatch.delenv(sanitizers.ENV_VAR, raising=False)
    assert sanitizers.install_from_env() is None
    monkeypatch.setenv(sanitizers.ENV_VAR, "locks")
    got = sanitizers.install_from_env()
    try:
        assert got is not None and sanitizers.install_from_env() is got
    finally:
        got.uninstall()


# ============================== pass 4: program lint fixtures (torch)
# one bad fixture record per pinned program rule; this dict also keeps
# every REGISTERED_PROGRAM_RULES id named by a test:
#   prog-fp32-matmul-under-policy, prog-unhonored-donation,
#   prog-transpose-churn, prog-hidden-host-transfer, prog-dead-output,
#   prog-excess-padding, prog-unsharded-optimizer-state
EXPECTED_BAD_PROGRAMS = {
    "prog-fp32-matmul-under-policy": "bad_fp32_matmul",
    "prog-unhonored-donation": "bad_unhonored_donation",
    "prog-transpose-churn": "bad_transpose_churn",
    "prog-hidden-host-transfer": "bad_host_transfer",
    "prog-dead-output": "bad_dead_output",
    "prog-excess-padding": "bad_excess_padding",
    "prog-unsharded-optimizer-state": "bad_unsharded_optimizer",
}


def _fixture_records(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_analysis_programs_{name}", PROGRAMS_FIX / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build_records()


@pytest.fixture(scope="module")
def bad_program_findings():
    return program_lint.run(_fixture_records("bad_programs"))


@pytest.mark.parametrize("rule,program",
                         sorted(EXPECTED_BAD_PROGRAMS.items()))
def test_bad_program_fixture_true_positive(bad_program_findings, rule,
                                           program):
    hits = [f for f in bad_program_findings if f.rule == rule]
    assert any(f.symbol == program for f in hits), hits


def test_bad_program_fixture_exact_shape_and_baseline(bad_program_findings):
    got = {(f.rule, f.symbol) for f in bad_program_findings}
    assert got == set(EXPECTED_BAD_PROGRAMS.items()), got
    bl = Baseline.from_findings(bad_program_findings)
    new, suppressed, stale = bl.apply(bad_program_findings)
    assert not new and not stale
    new2, _, stale2 = bl.apply(bad_program_findings[1:])
    assert not new2 and len(stale2) == 1


def test_clean_program_fixture_no_findings():
    finds, reports = program_lint.run_with_reports(
        _fixture_records("clean_programs"))
    assert finds == [], [f.render() for f in finds]
    # the numbers each rule read are in the reports
    rep = {r["name"]: r for r in reports}
    assert rep["clean_single_transpose"]["churn_ops"] == 1
    assert rep["clean_bf16_matmul"]["f32_matmul_ops"] == 0
    assert rep["clean_sharded_optimizer"]["opt_state_bytes"] == \
        rep["clean_sharded_optimizer"]["opt_plan_bytes"]


# ====================================== programs.py: every family
@pytest.fixture(scope="module")
def default_set():
    """The representative set as build_default_records builds it (the
    ZeRO-1 gang also linting its bad counterpart), timed, and linted
    once: (records by name, {name: findings}, {name: report}, build
    and lint seconds)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    t0 = time.perf_counter()
    gang = programs.Zero1Gang(include_bad=True).start()
    try:
        recs = (programs.engine_records() + programs.serving_records()
                + programs.decode_records() + programs.clustering_records()
                + programs.flagship_records() + gang.records())
        finds, reports = program_lint.run_with_reports(recs)
    finally:
        torch.set_num_threads(threads)
    secs = time.perf_counter() - t0
    by_name = {r.name: r for r in recs}
    f_by = {n: [f for f in finds if f.symbol == n] for n in by_name}
    return by_name, f_by, {r["name"]: r for r in reports}, secs


FAMILIES = ["engine_single", "engine_single_group_k4", "engine_graph",
            "engine_tbptt", "engine_zero1", "serving_predict",
            "serving_bucket_8", "decode_step_s4", "decode_prefill_c16",
            "decode_page_copy", "clustering_kmeans_lloyd",
            "clustering_tsne_step", "flagship_k_steps", "flagship_forward"]


def test_programs_mode_clean_under_60s(default_set):
    """The whole representative set builds and lints clean on the CPU
    inside the CLI's 60 s budget (the bad ZeRO-1 counterpart aside)."""
    by_name, f_by, reports, secs = default_set
    assert set(FAMILIES) <= set(by_name)
    new = [f for n, fs in f_by.items() if n != "bad_engine_zero1"
           for f in fs]
    assert new == [], [f.render() for f in new]
    assert secs < 60.0, secs


@pytest.mark.parametrize("name", FAMILIES)
def test_program_family_clean_at_cpu_widths(default_set, name):
    by_name, f_by, reports, _ = default_set
    assert f_by[name] == [], [f.render() for f in f_by[name]]
    rep = reports[name]
    if by_name[name].fn is not None or name == "engine_zero1":
        assert rep["ops"] > 0 and rep["host_sync_ops"] == 0


def _with_host_read(fn):
    def call(*args, **kwargs):
        out = fn(*args, **kwargs)
        first = out[0] if isinstance(out, (tuple, list)) else out
        while isinstance(first, (tuple, list, dict)):
            first = (list(first.values()) if isinstance(first, dict)
                     else first)[0]
        float(first.float().sum())
        return out
    return call


def _cloning(fn, argnum):
    def call(*args, **kwargs):
        args = list(args)
        args[argnum] = args[argnum].clone()
        return fn(*args, **kwargs)
    return call


def _bad_counterpart(name, rec):
    """(bad record, the rule it must fire) for each family."""
    rp = dataclasses.replace
    if name in ("engine_single", "flagship_k_steps"):
        # the same program of an f32 net, registered under bf16
        twin = (programs.engine_records(compute_dtype=None)[0]
                if name == "engine_single" else
                programs.flagship_records(compute_dtype=None, k=1)[0])
        return (rp(twin, precision_policy="bf16"),
                "prog-fp32-matmul-under-policy")
    if name in ("engine_single_group_k4", "engine_tbptt",
                "clustering_kmeans_lloyd"):
        return rp(rec, consumed_outputs=(0,)), "prog-dead-output"
    if name in ("engine_graph", "serving_predict", "flagship_forward"):
        return (rp(rec, fn=_with_host_read(rec.fn)),
                "prog-hidden-host-transfer")
    if name == "serving_bucket_8":
        return (rp(rec, bucket_rows_per_dispatch=1.0),
                "prog-excess-padding")
    if name in ("decode_step_s4", "decode_prefill_c16", "decode_page_copy",
                "clustering_tsne_step"):
        return (rp(rec, fn=_cloning(rec.fn, rec.inplace_argnums[0])),
                "prog-unhonored-donation")
    raise KeyError(name)


@pytest.mark.parametrize("name", FAMILIES)
def test_program_family_bad_counterpart_fires(default_set, name):
    by_name, f_by, _, _ = default_set
    if name == "engine_zero1":
        got = {f.rule for f in f_by["bad_engine_zero1"]}
        assert got == {"prog-unsharded-optimizer-state"}, got
        return
    bad, rule = _bad_counterpart(name, by_name[name])
    got = {f.rule for f in program_lint.run([bad])}
    assert rule in got, got


def test_zero1_record_holds_the_plans_slice(default_set):
    _, _, reports, _ = default_set
    good, bad = reports["engine_zero1"], reports["bad_engine_zero1"]
    assert good["ranks"] == 2
    assert good["opt_state_bytes"] == good["opt_plan_bytes"]
    assert bad["opt_state_bytes"] > bad["opt_plan_bytes"]


def test_flagship_records_run_the_four_kernels_in_bf16(default_set):
    """On the CPU each kernel call runs its plain version, counted on the
    "plain" route at its input dtype: every call of the four kernels is
    bf16 under the bf16 policy."""
    _, _, reports, _ = default_set
    kern = reports["flagship_k_steps"]["kernels"]
    names = {k.split("/")[0] for k in kern}
    assert names == {"fused_conv1x1", "fused_conv3x3", "dgrad_conv1x1",
                     "wgrad_conv1x1"}
    assert all(k.endswith("/plain/bf16") for k in kern), kern
    assert reports["flagship_k_steps"]["kernel_internal_ops"] > 0
    fwd = reports["flagship_forward"]["kernels"]
    assert set(fwd) == {"fused_conv1x1/plain/bf16",
                        "fused_conv3x3/plain/bf16"}


def test_launches_by_dtype_counter_resets_and_skips_the_cpu():
    from deeplearning4j_tpu_torch.nn.helpers import pallas_conv as pc

    pc._count_dtype("fused_conv1x1", "wgmma", torch.bfloat16)
    assert pc.LAUNCHES_BY_DTYPE == {("fused_conv1x1", "wgmma", "bf16"): 1}
    pc.reset_launch_counts()
    assert pc.LAUNCHES_BY_DTYPE == {}
    x = torch.zeros(4, 8)
    pc.fused_conv1x1(x, torch.zeros(8, 8), None)   # plain version: no launch
    assert pc.LAUNCHES_BY_DTYPE == {} and pc.LAUNCHES["fused_conv1x1"] == 0


# ============================== the three lint_records leave state alone
def test_step_lint_records_leave_the_net_as_it_was():
    """A dropout net linted, then stepped, matches its twin stepped
    without the lint bit for bit: the records ran on clones and the
    dropout generator was rewound."""
    from deeplearning4j_tpu_torch.engine import StepProgram
    from deeplearning4j_tpu_torch.nn.conf import (
        InputType,
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util.tree import leaves

    conf = (NeuralNetConfiguration.Builder().seed(4).updater("adam")
            .learning_rate(1e-2).activation("relu").weight_init("xavier")
            .list().layer(DenseLayer(n_out=12, dropout=0.5))
            .layer(OutputLayer(n_out=3, loss="mcxent"))
            .set_input_type(InputType.feed_forward(5)).build())
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
    a = MultiLayerNetwork(conf, device="cpu").init()
    b = MultiLayerNetwork(conf, device="cpu").init()
    pa = StepProgram(a)
    recs = pa.lint_records(x, y, k=2)
    assert [r.name for r in recs] == ["engine_single",
                                     "engine_single_group_k2"]
    assert all(r.precision_policy == "f32" for r in recs)
    assert program_lint.run(recs) == []
    assert a.iteration == 0
    la, lb = pa.run(x, y), StepProgram(b).run(x, y)
    assert torch.equal(la, lb)
    for ta, tb in zip(leaves(a.params), leaves(b.params)):
        assert torch.equal(ta, tb)


def test_decode_lint_records_move_no_trace_after_warmup():
    from deeplearning4j_tpu_torch.engine.decode_program import DecodeProgram
    from deeplearning4j_tpu_torch.zoo.decoder import CausalTransformer

    model = CausalTransformer(vocab_size=32, d_model=16, n_heads=2,
                              n_layers=1, max_ctx=32, seed=3,
                              device="cpu").init()
    prog = DecodeProgram(model, max_slots=2, page_size=8)
    prog.warmup(prog.init_kv())
    before = dict(prog.trace_stats()["trace_counts"])
    recs = prog.lint_records()
    assert [r.name for r in recs] == ["decode_step_s2", "decode_prefill_c8",
                                     "decode_page_copy"]
    assert all(r.inplace_argnums for r in recs)
    assert program_lint.run(recs) == []
    assert prog.trace_stats()["trace_counts"] == before
