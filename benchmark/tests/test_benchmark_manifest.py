"""The benchmark's manifest: every cell, configuration, traffic driver
and per-layer reader is a file found by name, BENCHMARK.json agrees with
them, the operation and byte counts, and the no-JAX guards."""

import ast
import json
import shutil
import subprocess
import sys

import pytest

from yardstick import device, flops, manifest

BENCH = manifest.ROOT
CHECKOUT = manifest.CHECKOUT
SPEC = json.loads((CHECKOUT / "BENCHMARK.json").read_text())


def _nodes(name):
    cfg = manifest.config(name)
    return manifest.reference(cfg["reference"]).build(cfg)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_workload_file_names_what_exists(cell):
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    wl = manifest.workload(cell)
    for key in ("config", "traffic", "chips", "why"):
        assert wl[key] == entry[key], key
    assert (BENCH / "configs" / f"{wl['config']}.json").is_file()
    cfg = manifest.config(wl["config"])
    assert (BENCH / "reference" / f"{cfg['reference']}.py").is_file()
    mod = manifest.traffic(wl["traffic"])
    e2e, per_layer = manifest.declared(cell)
    assert "setup_s" in e2e and len(e2e) >= 2 and per_layer
    assert set(e2e) <= set(mod.END_TO_END)
    assert set(wl["limits"]) and all(v >= 0 for v in wl["limits"].values())


@pytest.mark.parametrize("entry", SPEC["per_layer"],
                         ids=[m["name"] for m in SPEC["per_layer"]])
def test_per_layer_reader_matches_spec_and_moves_is_reported(entry):
    mod = manifest.metric(entry["name"])
    assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES, mod.BETTER) == (
        entry["layer"], entry["unit"], entry["source"], entry["moves"],
        entry["better"])
    for cell in entry["workloads"]:
        e2e, per_layer = manifest.declared(cell)
        assert entry["moves"] in e2e
        assert entry["name"] in per_layer
        traffic = manifest.traffic(manifest.workload(cell)["traffic"])
        assert entry["moves"] in traffic.END_TO_END


@pytest.mark.parametrize("entry", SPEC["configs"],
                         ids=[c["name"] for c in SPEC["configs"]])
def test_config_entry_matches_its_file(entry):
    cfg = json.loads((CHECKOUT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"]
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]


def test_every_declared_cell_and_metric_has_its_file():
    assert set(manifest.metric_names()) >= {m["name"]
                                            for m in SPEC["per_layer"]}
    assert set(manifest.workload_names()) >= {w["name"]
                                              for w in SPEC["workloads"]}


@pytest.mark.parametrize("cell", manifest.workload_names())
def test_every_workload_file_is_runnable_by_name(cell):
    """Every cell file names a configuration, reference and traffic
    that exist."""
    wl = manifest.workload(cell)
    cfg = manifest.config(wl["config"])
    assert manifest.reference(cfg["reference"]).build(cfg)
    assert manifest.traffic(wl["traffic"]).END_TO_END
    assert wl["chips"] in (1, 4) and wl["limits"]


@pytest.mark.parametrize("name", manifest.metric_names())
def test_every_metric_file_reads_nothing_from_an_empty_run(name):
    mod = manifest.metric(name)
    assert mod.UNIT and mod.LAYER and mod.MOVES and mod.BETTER in (
        "higher", "lower")
    for kind in ("train", "another"):
        assert mod.read({"kind": kind, "window": {"seconds": 0,
                                                  "images": 0}}) is None


def test_a_new_cell_and_metric_are_found_from_added_files(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "workloads" / "resnet50-train-b64.json").write_text(json.dumps({
        "config": "resnet50", "traffic": "train", "chips": 1,
        "why": "a test cell", "params": {"batch": 64}, "limits": {
            "loss_gap": 1.0}}))
    (root / "metrics" / "step_ms.train.py").write_text(
        "LAYER = 'model step'\nUNIT = 'ms'\n"
        "SOURCE = 'host_clock'\nMOVES = 'train_img_per_s'\n"
        "BETTER = 'lower'\n\ndef read(run):\n    return 1.0\n")
    assert "resnet50-train-b64" in manifest.workload_names(root)
    wl = manifest.workload("resnet50-train-b64", root)
    assert wl["params"]["batch"] == 64
    assert manifest.traffic(wl["traffic"], root).END_TO_END
    assert "step_ms.train" in manifest.metric_names(root)
    assert manifest.metric("step_ms.train", root).read({}) == 1.0
    after = {p: p.read_bytes() for p in before}
    assert after == before   # nothing that was there changed


def test_flops_and_bytes_of_a_1x1_and_a_3x3_by_hand():
    c1 = {"h": 56, "w": 56, "cin": 64, "cout": 256, "k": (1, 1),
          "s": (1, 1)}
    f, b = flops.forward_call(c1, 128)
    m = 128 * 56 * 56
    assert f == 2 * m * 64 * 256 == 13_153_337_344
    assert b == 2 * (m * 64 + 64 * 256 + m * 256) == 256_933_888
    t, by = flops.bound_s(f, b)
    assert by == "bytes" and t == pytest.approx(256_933_888 / 3.35e12)
    f, b = flops.dgrad_call(c1, 128)
    assert f == 13_153_337_344
    assert b == 2 * (m * 256 + 64 * 256 + m * 64)
    f, b = flops.wgrad_call(c1, 128)
    assert b == 2 * (m * 64 + m * 256) + 4 * 64 * 256
    c3 = {"h": 14, "w": 14, "cin": 256, "cout": 256, "k": (3, 3),
          "s": (1, 1)}
    f, b = flops.forward_call(c3, 128)
    m = 128 * 14 * 14
    assert f == 2 * m * 9 * 256 * 256 == 29_595_009_024
    assert b == 2 * (m * 256 + 9 * 256 * 256 + m * 256) == 26_869_760
    t, by = flops.bound_s(f, b)
    assert by == "operations" and t == pytest.approx(f / 989e12)


def test_model_counts_match_the_architectures():
    r = _nodes("resnet50")
    assert 3.8e9 < flops.forward_macs(r) < 4.2e9
    work = flops.hand_kernel_work(r, 128, train=True)
    assert work["fwd"]["calls"] == {"fused_conv1x1": 30, "fused_conv3x3": 16}
    assert work["bwd"]["calls"] == {"dgrad_conv1x1": 30, "wgrad_conv1x1": 30}
    g = _nodes("googlenet")
    assert 1.4e9 < flops.forward_macs(g) < 1.7e9
    work = flops.hand_kernel_work(g, 128, train=True)
    assert work["fwd"]["calls"] == {"fused_conv1x1": 37, "fused_conv3x3": 10}


@pytest.mark.parametrize("name,direction", [
    ("void (anonymous namespace)::wg::conv1x1_wgmma_kernel<2, 128>("
     "(anonymous namespace)::wg::Args)", "fwd"),
    ("dl4j::fused_gemm_kernel<float, Loader>(...)", "fwd"),
    ("void (anonymous namespace)::wg::dgrad_wgmma_kernel<128>(...)", "bwd"),
    ("dl4j::tile_sum_kernel(dl4j::TileSums, int)", "bwd"),
    ("(anonymous namespace)::split_sum_kernel(float const*, int)", "bwd"),
    ("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
     "tilesize128x128x64_kernel__5x_cudnn", None),
    ("void at::native::reduce_kernel<128, 4>(...)", None),
])
def test_kernel_names_are_classified(name, direction):
    assert flops.kernel_direction(name) == direction


def test_forbidden_modules_compare_whole_top_level_names():
    mods = {"jax": 0, "jax.numpy": 0, "deeplearning4j_tpu_torch": 0,
            "deeplearning4j_tpu_torch.nn": 0, "jaxtyping": 0,
            "deeplearning4j_tpu.nn.graph": 0, "flaxen": 0}
    assert device.forbidden_modules(mods) == ["deeplearning4j_tpu", "jax"]


def test_run_path_imports_no_jax():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import run, control\n"
        "from yardstick import manifest, program, trace, readers\n"
        "for w in manifest.workload_names():\n"
        "    manifest.traffic(manifest.workload(w)['traffic'])\n"
        "for m in manifest.metric_names():\n"
        "    manifest.metric(m)\n"
        "import deeplearning4j_tpu_torch.parallel.training_master\n"
        "import deeplearning4j_tpu_torch.zoo\n"
        "from yardstick import device\n"
        "assert device.forbidden_modules() == [], device.forbidden_modules()\n"
        "print('clean')\n") % (str(BENCH), str(CHECKOUT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr[-2000:]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax_or_the_repo_s_other_benchmarks(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "deeplearning4j_tpu",
                       "chip_smoke", "bench", "bench_serving", "bench_obs",
                       "bench_resilience", "tools"}
    if path.parent.name == "reference":
        assert "deeplearning4j_tpu_torch" not in tops


def test_run_without_a_card_exits_nonzero_and_prints_nothing(tmp_path):
    for root in (CHECKOUT, tmp_path):
        if root == tmp_path:   # only BENCHMARK.json and the benchmark
            shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
            shutil.copytree(BENCH, tmp_path / "benchmark",
                            ignore=shutil.ignore_patterns("__pycache__"))
        out = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload",
             "resnet50-train-b128", "--seed", str(2 ** 31 + 9),
             "--seconds", "1", "--trace", "0"], cwd=root,
            capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert out.stdout.strip() == ""
