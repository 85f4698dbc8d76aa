"""The port's analyzer held against the JAX package's, on the CPU: the
passes they share (concurrency, conformance, baseline and pragmas, and
jit-host-sync) give the same findings on the JAX package's own fixtures
(tests/fixtures/analysis_cases), the same two-thread lock script gives
the same edges and cycle under both sanitizers, the same bf16 MLP (its
weights carried across by util.model_serializer.params_from_jax) lints
clean in both program lints and fires prog-fp32-matmul-under-policy in
both once its f32 twin is registered under bf16, and the same bucket
statistics give the same prog-excess-padding verdict. JAX's
prog-unsharded-optimizer-state is not compared: its clean fixture fails
in the JAX package itself; the port's rule is held to its own fixtures
(tests/test_torch_analysis.py)."""

import dataclasses
import os
import textwrap
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu import analysis as janalysis
from deeplearning4j_tpu.analysis import program_lint as jprogram_lint
from deeplearning4j_tpu.analysis import sanitizers as jsanitizers
from deeplearning4j_tpu.engine import StepProgram as JStepProgram
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu_torch import analysis as tanalysis
from deeplearning4j_tpu_torch.analysis import program_lint as tprogram_lint
from deeplearning4j_tpu_torch.analysis import sanitizers as tsanitizers
from deeplearning4j_tpu_torch.engine import StepProgram
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.util.model_serializer import params_from_jax

ROOT = Path(__file__).resolve().parent.parent
JCASES = ROOT / "tests" / "fixtures" / "analysis_cases"
SHARED_PASSES = ("concurrency", "conformance")


def _shared(f) -> bool:
    """A finding of a pass both packages run with the same rules."""
    rule = tanalysis.RULES.get(f.rule)
    return rule is not None and (rule.pass_name in SHARED_PASSES
                                 or f.rule == "jit-host-sync")


def _key(f):
    return (f.rule, f.file, f.line, f.symbol)


# ================================================ the shared AST passes
@pytest.mark.parametrize("case", ["bad", "clean"])
@pytest.mark.parametrize("passes", [("jit",), ("concurrency",),
                                    ("conformance",)])
def test_shared_passes_same_findings_on_jax_fixtures(case, passes):
    d = JCASES / case
    jf = janalysis.analyze(d, root=ROOT, tests_dir=None, passes=passes)
    tf = tanalysis.analyze(d, root=ROOT, tests_dir=None, passes=passes)
    want = sorted(_key(f) for f in jf.findings if _shared(f))
    got = sorted(_key(f) for f in tf.findings if _shared(f))
    assert got == want
    if case == "bad" and passes != ("jit",):
        assert got    # the shared rules do fire there


def test_jax_baseline_suppresses_the_ports_shared_findings():
    """The thread and registry rules keep their messages, so a baseline
    the JAX package writes for them suppresses the port's findings
    (fingerprint = rule, file, symbol, message)."""
    d = JCASES / "bad"
    passes = SHARED_PASSES
    jf = janalysis.analyze(d, root=ROOT, tests_dir=None,
                           passes=passes).findings
    bl = janalysis.Baseline.from_findings(jf)
    port = tanalysis.analyze(
        d, root=ROOT, tests_dir=None, passes=passes,
        baseline=tanalysis.Baseline(entries=list(bl.entries)))
    assert port.clean and not port.stale
    assert len(port.suppressed) == len(jf)


def test_pragmas_same_in_both(tmp_path):
    pkg = tmp_path / "minipkg"
    pkg.mkdir()
    (pkg / "mod.py").write_text(textwrap.dedent("""\
        import threading

        def fit(x):
            # analyze: allow=jit-host-sync — the drill's one read
            y = x.item()
            # analyze: allow=thr-unnamed-thread,thr-orphan-thread — drill
            t = threading.Thread(target=print, daemon=True)
            t.start()
            threading.Thread(target=print, daemon=True).start()
            try:
                y = x.tolist()
            except Exception:
                pass
            return y
    """))
    jf = janalysis.analyze(pkg, root=tmp_path, tests_dir=None).findings
    tf = tanalysis.analyze(pkg, root=tmp_path, tests_dir=None).findings
    want = sorted(_key(f) for f in jf if _shared(f))
    assert sorted(_key(f) for f in tf if _shared(f)) == want
    assert {f.rule for f in tf} >= {"thr-unnamed-thread",
                                    "reg-swallowed-exception",
                                    "jit-host-sync"}


# ============================================== the lock-order sanitizer
def _lock_script(san_cls):
    san = san_cls(long_hold_s=30.0).install()
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

        for fn, name in ((a_then_b, "p-ab"), (b_then_a, "p-ba")):
            t = threading.Thread(target=fn, name=name, daemon=True)
            t.start()
            t.join(timeout=10.0)
        return ({(e.src, e.dst) for e in san.edges()}, san.cycles(),
                [v["rule"] for v in san.violations()])
    finally:
        san.uninstall()


def test_same_edges_and_cycle_under_both_sanitizers():
    if jsanitizers.active_sanitizer() is not None \
            or "locks" in os.environ.get(jsanitizers.ENV_VAR, ""):
        pytest.skip("a session lock sanitizer is active")
    j = _lock_script(jsanitizers.LockOrderSanitizer)
    t = _lock_script(tsanitizers.LockOrderSanitizer)
    assert t == j
    assert len(t[1]) == 1 and t[2] == ["san-lock-order-cycle"]


# ============================================== the program lints
@pytest.fixture(scope="module")
def mlps():
    """(JAX bf16 MLP, port bf16 MLP with its weights, JAX f32 MLP, port
    f32 MLP with its weights)."""
    conf = (JNNC.Builder().seed(7).updater("adam").learning_rate(1e-3)
            .activation("relu").weight_init("xavier").list()
            .layer(JDense(n_out=32))
            .layer(JOut(n_out=8, loss="mcxent"))
            .set_input_type(JInputType.feed_forward(16)).build())
    out = []
    for cd, tcd in (("bfloat16", "bfloat16"), (None, None)):
        jnet = JMLN(conf, compute_dtype=cd).init()
        tnet = MultiLayerNetwork(
            MultiLayerConfiguration.from_json(conf.to_json()),
            compute_dtype=tcd, device="cpu").init()
        tonp = lambda t: jax.tree_util.tree_map(np.asarray, t)
        tnet.params, tnet.states = params_from_jax(
            tonp(jnet.params), tonp(jnet.states), device="cpu")
        out += [jnet, tnet]
    return out


def _batch():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(8, 16)).astype(np.float32)
    y = np.eye(8, dtype=np.float32)[rng.integers(0, 8, 8)]
    return x, y


def test_bf16_mlp_lints_clean_in_both(mlps):
    jnet, tnet, _, _ = mlps
    x, y = _batch()
    jrecs = JStepProgram(jnet).lint_records(jnp.asarray(x), jnp.asarray(y))
    trecs = StepProgram(tnet).lint_records(x, y)
    assert [r.precision_policy for r in jrecs] == ["bf16"]
    assert [r.precision_policy for r in trecs] == ["bf16"]
    assert jprogram_lint.run(jrecs) == []
    assert tprogram_lint.run(trecs) == []


def test_f32_matmul_under_bf16_fires_in_both(mlps):
    _, _, jnet, tnet = mlps
    x, y = _batch()
    jrec = JStepProgram(jnet).lint_records(jnp.asarray(x),
                                           jnp.asarray(y))[0]
    trec = StepProgram(tnet).lint_records(x, y)[0]
    assert jrec.precision_policy == trec.precision_policy == "f32"
    rule = "prog-fp32-matmul-under-policy"
    jf = jprogram_lint.run([dataclasses.replace(
        jrec, precision_policy="bf16", compile=False)])
    tf = tprogram_lint.run([dataclasses.replace(
        trec, precision_policy="bf16")])
    assert {f.rule for f in jf} == {f.rule for f in tf} == {rule}


@pytest.mark.parametrize("capacity,rows", [(32, 3.0), (8, 4.0), (8, 3.9),
                                           (16, 15.0)])
def test_same_excess_padding_verdict(capacity, rows):
    jf = jprogram_lint.run([jprogram_lint.ProgramRecord(
        name="b", bucket_capacity=capacity, bucket_rows_per_dispatch=rows)])
    tf = tprogram_lint.run([tprogram_lint.ProgramRecord(
        name="b", bucket_capacity=capacity, bucket_rows_per_dispatch=rows)])
    assert [f.rule for f in tf] == [f.rule for f in jf]
    assert [f.message for f in tf] == [
        f.message.replace("the MXU runs", "the tensor cores run")
        for f in jf]
