"""The representative program set `tools/analyze_torch.py --programs`
lints (counterpart of deeplearning4j_tpu/analysis/programs.py).

One small instance of every registered program family, built the way
production builds them (the same StepProgram, ParallelInference and
DecodeProgram paths, the same policy registration) at CPU-lintable
widths:

  engine_single / _group_k4   StepProgram on a bf16 mixed-precision MLP
  engine_graph                StepProgram on a ComputationGraph
  engine_tbptt                one truncated-BPTT chunk step of an LSTM
  engine_zero1                the ZeRO-1 step over a 2-rank gloo gang of
                              CPU processes this module starts itself
                              (`python -m deeplearning4j_tpu_torch.analysis
                              .programs --zero1-rank R ...`): one process
                              cannot fake a dp axis, so the ranks lint the
                              record together and send back their findings
                              — the prog-unsharded-optimizer-state record
  serving_predict / buckets   ParallelInference warmup + a short driven
                              load, so bucket fill is MEASURED
  decode_step / decode_prefill / decode_page_copy
                              the continuous-batching decode programs, the
                              KV pool DECLARED updated in place
  clustering_kmeans_lloyd     one Lloyd iteration
  clustering_tsne_step        the streamed t-SNE step, y and vel declared
                              updated in place
  flagship_k_steps            ResNet-50 "pallas" bf16 at reduced dims: a
                              run_group(2) body (its four hand kernels run
                              their plain versions on the CPU)
  flagship_forward            the same net's predict program

Everything here imports torch — the runner loads it ONLY in
`--programs` mode, so the default AST-only CLI keeps its zero-dependency
contract. The whole set builds and lints in well under 60 s on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import List

from deeplearning4j_tpu_torch.analysis.program_lint import ProgramRecord

_ROOT = Path(__file__).resolve().parents[2]
ZERO1_WORLD = 2
ZERO1_WAIT_S = 120.0


def _mlp(seed=7, n_in=16, hidden=32, n_out=8, compute_dtype="bfloat16",
         updater="adam"):
    from deeplearning4j_tpu_torch.nn.conf import (
        InputType,
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.Builder().seed(seed).updater(updater)
            .learning_rate(1e-3).activation("relu")
            .weight_init("xavier").list()
            .layer(DenseLayer(n_out=hidden))
            .layer(OutputLayer(n_out=n_out, loss="mcxent"))
            .set_input_type(InputType.feed_forward(n_in)).build())
    return MultiLayerNetwork(conf, compute_dtype=compute_dtype,
                             device="cpu").init()


def _onehot(np, rows, n, seed=0):
    rng = np.random.default_rng(seed)
    return np.eye(n, dtype=np.float32)[rng.integers(0, n, rows)]


def engine_records(compute_dtype="bfloat16") -> List[ProgramRecord]:
    import numpy as np

    from deeplearning4j_tpu_torch.engine import StepProgram
    from deeplearning4j_tpu_torch.nn.conf import (
        InputType,
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.layers import (
        LSTM,
        DenseLayer,
        OutputLayer,
        RnnOutputLayer,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    rng = np.random.default_rng(1)
    records: List[ProgramRecord] = []
    # single step + k-group on the bf16 mixed-precision MLP
    net = _mlp(compute_dtype=compute_dtype)
    records += StepProgram(net).lint_records(
        rng.normal(size=(8, 16)).astype(np.float32), _onehot(np, 8, 8),
        k=4)

    # ComputationGraph variant
    gconf = (NeuralNetConfiguration.Builder().seed(5).updater("adam")
             .learning_rate(1e-3).activation("relu")
             .weight_init("xavier").graph_builder()
             .add_inputs("in")
             .add_layer("d1", DenseLayer(n_out=16), "in")
             .add_layer("out", OutputLayer(n_out=4, loss="mcxent"), "d1")
             .set_outputs("out")
             .set_input_types(**{"in": InputType.feed_forward(8)})
             .build())
    g = ComputationGraph(gconf, compute_dtype=compute_dtype,
                         device="cpu").init()
    records += StepProgram(g).lint_records(
        rng.normal(size=(8, 8)).astype(np.float32), _onehot(np, 8, 4))

    # truncated-BPTT LSTM: one chunk step from zero carries
    rconf = (NeuralNetConfiguration.Builder().seed(3).updater("adam")
             .learning_rate(1e-3).weight_init("xavier").list()
             .layer(LSTM(n_out=16))
             .layer(RnnOutputLayer(n_out=4, loss="mcxent"))
             .set_input_type(InputType.recurrent(8))
             .backprop_type("truncated_bptt")
             .t_bptt_forward_length(4).t_bptt_backward_length(4)
             .build())
    rnet = MultiLayerNetwork(rconf, compute_dtype=compute_dtype,
                             device="cpu").init()
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (2, 8))]
    records += StepProgram(rnet).lint_records(
        rng.normal(size=(2, 8, 8)).astype(np.float32), y)
    return records


def serving_records() -> List[ProgramRecord]:
    import numpy as np

    from deeplearning4j_tpu_torch.parallel.inference import (
        ParallelInference,
    )

    net = _mlp(seed=11, updater="sgd")
    pi = ParallelInference(net, batch_limit=8, queue_limit=16,
                           max_wait_ms=1.0, warmup=True, pipeline_depth=0)
    try:
        # drive a short load so bucket fill is measured, not assumed
        for rows in (8, 8, 4):
            pi.output(np.zeros((rows, 16), np.float32), timeout_s=60.0)
        return pi.lint_records()
    finally:
        pi.shutdown()


def decode_records() -> List[ProgramRecord]:
    from deeplearning4j_tpu_torch.engine.decode_program import DecodeProgram
    from deeplearning4j_tpu_torch.zoo.decoder import CausalTransformer

    model = CausalTransformer(vocab_size=64, d_model=32, n_heads=4,
                              n_layers=2, max_ctx=64, seed=17,
                              device="cpu").init()
    return DecodeProgram(model, max_slots=4, page_size=16).lint_records()


def clustering_records() -> List[ProgramRecord]:
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.clustering import kmeans, tsne

    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.normal(size=(32, 4)).astype(np.float32))
    records = [ProgramRecord(
        name="clustering_kmeans_lloyd", fn=kmeans._lloyd_step,
        example_args=(pts, pts[:4].clone(), "euclidean"),
        precision_policy="f32", consumed_outputs=(0, 1, 2, 3),
        source="deeplearning4j_tpu_torch/clustering/kmeans.py")]
    # n_pad = 256 rows of 2 columns: past the in-place rule's 1 KB floor
    n, k, blk, c = 200, 3, 64, 2
    n_pad = -(-n // blk) * blk
    y = torch.from_numpy(rng.normal(size=(n_pad, c)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, n, (n, k)))
    records.append(ProgramRecord(
        name="clustering_tsne_step", fn=tsne._chunked_step,
        example_args=(y, torch.zeros_like(y), idx,
                      torch.full((n, k), 1e-3), torch.zeros((n, k),
                                                            dtype=bool),
                      4.0, 0.5, 100.0, blk, n),
        inplace_argnums=(0, 1), precision_policy="f32",
        consumed_outputs=(0, 1, 2),
        source="deeplearning4j_tpu_torch/clustering/tsne.py"))
    return records


def flagship_records(hw=32, batch=2, k=2,
                     compute_dtype="bfloat16") -> List[ProgramRecord]:
    """ResNet-50 "pallas" at reduced dims: the run_group(k) body and the
    predict program."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch.engine import StepProgram
    from deeplearning4j_tpu_torch.zoo import ResNet50

    net = ResNet50(num_classes=8, input_shape=(hw, hw, 3),
                   compute_dtype=compute_dtype,
                   helpers="pallas").init_model(device="cpu")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(batch, hw, hw, 3)).astype(np.float32)
    recs = StepProgram(net).lint_records(x, _onehot(np, batch, 8), k=k)
    group = dataclasses.replace(recs[1], name="flagship_k_steps")
    predict = net._jit_cache["predict"]

    def flagship_forward(params, states, inputs):
        with torch.inference_mode():
            return predict(params, states, inputs)

    fwd = ProgramRecord(
        name="flagship_forward", fn=flagship_forward,
        example_args=(net._compute_params(), net.states,
                      {net.conf.network_inputs[0]: torch.from_numpy(x)}),
        precision_policy=net._jit_cache.policy("predict"),
        source="deeplearning4j_tpu_torch/zoo/models.py")
    return [group, fwd]


# ---------------------------------------------------------- ZeRO-1 gang
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Zero1Gang:
    """engine_zero1 linted by a 2-rank gloo gang of CPU processes, started
    by `start()` so the gang lints while this process builds the other
    records; `records()` waits for it and returns the ranks' findings
    and rank 0's report as `lint_result` records. `include_bad` adds
    `bad_engine_zero1`: the same registration stepping the whole
    (unsharded) updater state."""

    def __init__(self, include_bad: bool = False):
        self.include_bad = include_bad
        self._out = None
        self._procs = []

    def start(self) -> "Zero1Gang":
        port = _free_port()
        env = dict(os.environ)
        env["PYTHONPATH"] = str(_ROOT) + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH")
            else "")
        self._out = tempfile.TemporaryDirectory()
        self._procs = [subprocess.Popen(
            [sys.executable, "-m", "deeplearning4j_tpu_torch.analysis."
             "programs", "--zero1-rank", str(r), "--world",
             str(ZERO1_WORLD), "--port", str(port), "--out",
             self._out.name] + (["--bad"] if self.include_bad else []),
            env=env, cwd=str(_ROOT), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for r in range(ZERO1_WORLD)]
        return self

    def records(self) -> List[ProgramRecord]:
        logs, rcs = [], []
        try:
            for p in self._procs:
                try:
                    logs.append(p.communicate(timeout=ZERO1_WAIT_S)[0])
                except subprocess.TimeoutExpired:
                    p.kill()
                    logs.append(p.communicate()[0])
                rcs.append(p.returncode)
            if any(rcs):
                raise RuntimeError(f"the ZeRO-1 lint gang failed {rcs}:\n"
                                   + "\n".join(lg[-2000:] for lg in logs))
            results = []
            for r in range(ZERO1_WORLD):
                with open(os.path.join(self._out.name,
                                       f"rank-{r}.json")) as f:
                    results.append(json.load(f))
        finally:
            for p in self._procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            self._out.cleanup()
        records = []
        for name, rep in results[0]["reports"].items():
            seen, finds = set(), []
            for res in results:
                for d in res["findings"]:
                    if d["symbol"] == name and d["fingerprint"] not in seen:
                        seen.add(d["fingerprint"])
                        finds.append(d)
            records.append(ProgramRecord(
                name=name,
                source="deeplearning4j_tpu_torch/engine/sharding.py",
                lint_result=(finds, dict(rep, ranks=ZERO1_WORLD))))
        return records


def _zero1_rank_records(include_bad: bool) -> List[ProgramRecord]:
    import numpy as np

    from deeplearning4j_tpu_torch.engine import MeshManager, StepProgram
    from deeplearning4j_tpu_torch.parallel import collectives
    from deeplearning4j_tpu_torch.util.tree import clone

    w = collectives.world_size()
    net = _mlp(seed=13, n_in=2 * w, hidden=4 * w, n_out=w,
               compute_dtype=None)
    prog = StepProgram(net).attach_mesh(MeshManager())
    rng = np.random.default_rng(collectives.rank())
    rec = prog.lint_record_zero1(
        rng.normal(size=(2 * w, 2 * w)).astype(np.float32),
        _onehot(np, 2 * w, w))
    records = [rec]
    if include_bad:
        # the registration's plan, the whole state: the replicated step
        full = net._pack([net._updaters[k].init(net.params[k])
                          for k, _ in net._layer_items()])
        p, _, s, *rest = rec.example_args

        def replicated_step(p, u, s, inputs, labels, lmasks, scalars,
                            fmasks):
            return net._step((p, u, s), inputs, labels, lmasks, scalars,
                             fmasks)

        records.append(dataclasses.replace(
            rec, name="bad_engine_zero1", fn=replicated_step,
            example_args=(clone(p), full, s, *rest)))
    return records


def zero1_rank_main(argv=None) -> int:
    """One rank of the ZeRO-1 lint gang: join the gloo group, lint the
    records, write this rank's findings and reports."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--zero1-rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--bad", action="store_true")
    a = ap.parse_args(argv)
    import torch

    from deeplearning4j_tpu_torch.analysis import program_lint
    from deeplearning4j_tpu_torch.parallel import collectives

    torch.set_num_threads(1)
    collectives.init_process_group(f"127.0.0.1:{a.port}", a.world,
                                   a.zero1_rank, device="cpu")
    try:
        recs = _zero1_rank_records(a.bad)
        finds, reports = program_lint.run_with_reports(recs)
    finally:
        collectives.destroy_process_group()
    with open(os.path.join(a.out, f"rank-{a.zero1_rank}.json"), "w") as f:
        json.dump({"findings": [x.to_dict() for x in finds],
                   "reports": {r["name"]: r for r in reports}}, f)
    return 0


def build_default_records() -> List[ProgramRecord]:
    """Build the whole representative set on the CPU."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 4))
    gang = Zero1Gang().start()
    try:
        records: List[ProgramRecord] = []
        records += engine_records()
        records += serving_records()
        records += decode_records()
        records += clustering_records()
        records += flagship_records()
        records += gang.records()
    finally:
        torch.set_num_threads(threads)
    return records


if __name__ == "__main__":
    sys.exit(zero1_rank_main())
