"""Pass 4 — the program lint: below the source, into the ops a program
runs (counterpart of deeplearning4j_tpu/analysis/program_lint.py).

The JAX pass reads what the compiler was handed (jaxpr, lowered and
compiled HLO). The port's programs run eagerly, so its evidence is the
op stream of one call: each registered program (the StepProgram single,
graph, TBPTT, ZeRO-1 and k-group steps, the serving predict program and
bucket records, the decode step and chunk prefill, the clustering
steps, the flagship train step and forward) is called ONCE on its
example arguments under an op recorder, and checked against its
*declared* facts:

  prog-fp32-matmul-under-policy  an aten mm/addmm/bmm/linear/convolution
                                 op, or a hand-kernel launch, in f32 (a
                                 kernel also on its "simple" route)
                                 under a declared bf16/f16 policy
  prog-unhonored-donation        an argument declared updated in place
                                 (`inplace_argnums`, the counterpart of
                                 donate_argnums) whose storage changed,
                                 or that an op copied whole
  prog-transpose-churn           permute/contiguous/clone/copy bytes
                                 above threshold
  prog-hidden-host-transfer      aten._local_scalar_dense, a
                                 data-dependent-shape op or a copy to the
                                 CPU inside a hot program
  prog-dead-output               computed outputs no caller consumes
  prog-excess-padding            serving pow2 bucket fill below threshold
  prog-unsharded-optimizer-state a ZeRO-1 record's per-rank optimizer
                                 state larger than the MeshManager
                                 plan's slice

The recorder is a `TorchDispatchMode`: it sees every aten op below
autograd — forward and backward, on the CPU and on CUDA — with its
dtypes, devices, shapes and storages. (FX needs a traceable function
and loses the kernels' ctypes calls and data-dependent branches;
torch.profiler sees CUDA kernels but not the operand dtypes in a form
the rules can read.) The hand kernels launch through ctypes, which the
dispatcher never sees, so the recorder also wraps the four wrappers of
nn/helpers/pallas_conv.py for the call: a launch is read from the
wrapper's count by (kernel, route, dtype) (`pallas_conv.LAUNCHES_BY_DTYPE`);
on the CPU, where a wrapper runs its kernel's plain version, the call
is counted on the "plain" route at its input dtype. The plain
version's own aten ops (an f32 product standing in for the kernel's f32
accumulation, the permutes around its convolution) are the kernel's,
not the program's: they are counted apart and no rule reads them.

Transpose churn counts bytes that a layout change really moves: the
output of clone (`.contiguous()` dispatches as clone), copy_ and a
same-dtype same-device `_to_copy`, and a non-contiguous permute or
transpose view when a later op other than a matmul reads it (a matmul
reads a transposed operand in place). Program traffic is every
recorded op's input and output bytes (a view's none, an in-place op's
inputs only) plus each kernel call's. The thresholds are the JAX
pass's.

Declared facts, not guesses: the policy comes from the net's compute
dtype (nn/jit_cache.policy_name) as registered on the program, the
in-place arguments from the program's contract (the decode pool), the
consumed outputs and the ZeRO-1 plan from the registration.

This module stays import-light at module scope (no torch) so the
default AST-only CLI keeps its zero-dependency contract; torch is
imported only when a record is linted.

Messages carry no measured number (a finding's fingerprint includes its
message, and the numbers move with the width); each record's report
carries them.

Rule ids are PINNED: `REGISTERED_PROGRAM_RULES` below is the registry
the conformance pass checks the findings.py catalog against, so a rule
cannot be added, renamed, or dropped without the registry — and its
tests — moving in the same commit.
"""

from __future__ import annotations

import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.analysis.findings import Finding

# pinned program-rule registry (conformance pass checks catalog == this)
REGISTERED_PROGRAM_RULES = frozenset({
    "prog-fp32-matmul-under-policy",
    "prog-unhonored-donation",
    "prog-transpose-churn",
    "prog-hidden-host-transfer",
    "prog-dead-output",
    "prog-excess-padding",
    "prog-unsharded-optimizer-state",
})

# precision policies a program can declare (nn/jit_cache.policy_name)
MIXED_POLICIES = ("bf16", "f16")

MATMUL_OPS = frozenset({
    "mm", "addmm", "bmm", "baddbmm", "addbmm", "linear", "matmul", "mv",
    "addmv", "dot", "convolution", "_convolution", "convolution_backward",
    "cudnn_convolution", "mkldnn_convolution",
    "convolution_overrideable", "_scaled_dot_product_flash_attention",
    "_scaled_dot_product_efficient_attention",
    "_scaled_dot_product_cudnn_attention",
    "_scaled_dot_product_flash_attention_for_cpu",
})
# ops that read a device value back to the host (or size their output
# from one)
HOST_SYNC_OPS = frozenset({
    "_local_scalar_dense", "item", "is_nonzero", "nonzero",
    "masked_select", "_unique2", "_unique", "unique_dim",
    "unique_consecutive", "bincount", "repeat_interleave",
})
LAYOUT_VIEW_OPS = frozenset({"permute", "transpose", "t", "swapaxes",
                             "movedim"})
COPY_OPS = frozenset({"clone", "copy_", "_to_copy"})
# ops that build a whole new version of their first operand: one applied
# to an in-place argument copies it (a gather, a concatenation into a
# derived operand, an elementwise temporary or a reduction only reads it)
WHOLE_COPY_OPS = frozenset({
    "clone", "_to_copy", "copy_", "index_put", "index_add", "index_copy",
    "scatter", "scatter_add", "scatter_reduce", "masked_fill",
    "masked_scatter", "slice_scatter", "select_scatter",
    "as_strided_scatter"})

# the hand kernels' wrappers (nn/helpers/pallas_conv.py)
KERNELS = ("fused_conv1x1", "fused_conv3x3", "dgrad_conv1x1",
           "wgrad_conv1x1")

@dataclass
class Thresholds:
    """Tunable rule thresholds — the JAX pass's, kept as they are
    (PERF.md records the measured margins): real backward passes
    legitimately copy and transpose, so churn flags on the *fraction* of
    program traffic, not the raw count."""

    # prog-transpose-churn: flag when BOTH hold
    transpose_min_ops: int = 8
    transpose_bytes_frac: float = 0.25
    # prog-unhonored-donation: leaves smaller than this never flag
    min_donated_bytes: int = 1024
    # prog-excess-padding: minimum average bucket fill ratio
    min_bucket_fill: float = 0.5


@dataclass
class ProgramRecord:
    """One registered program, with its declared facts.

    `fn(*example_args, **example_kwargs)` is called once under the
    recorder; `restore()` (when given) runs after it, so a record built
    on a live net rewinds what the call advanced (the dropout
    generator). `fn=None` records carry only registration metadata (the
    serving bucket fill records) or, for a program linted in other
    processes (the ZeRO-1 gang), the result those processes returned
    (`lint_result`: finding dicts and the report)."""

    name: str
    fn: Optional[Callable] = None
    example_args: Tuple = ()
    example_kwargs: Dict[str, Any] = field(default_factory=dict)
    # argument indices the program updates in place (the counterpart of
    # donate_argnums: the decode programs' KV pool)
    inplace_argnums: Tuple[int, ...] = ()
    precision_policy: Optional[str] = None    # "bf16" | "f16" | "f32"
    consumed_outputs: Optional[Tuple[int, ...]] = None  # None = all
    source: str = "deeplearning4j_tpu_torch/analysis/programs.py"
    # a hot program runs per step or per request: a host read in it
    # blocks every call
    hot: bool = True
    # serving bucket metadata (prog-excess-padding)
    bucket_capacity: Optional[int] = None
    bucket_rows_per_dispatch: Optional[float] = None
    # ZeRO-1 registration facts (prog-unsharded-optimizer-state): the
    # argument indices holding this rank's optimizer state, and the
    # bytes the MeshManager plan gives this rank
    sharded_argnums: Tuple[int, ...] = ()
    shard_plan_bytes: Optional[int] = None
    restore: Optional[Callable[[], None]] = None
    # facts read elsewhere when the record was built (a captured group's
    # launches and collectives): printed with the report
    notes: Dict[str, Any] = field(default_factory=dict)
    lint_result: Optional[Tuple[List[dict], dict]] = None


# ------------------------------------------------------------ recording
_PATCH_LOCK = threading.Lock()


def _short(dtype) -> str:
    """The dtype's short name, as the kernels' launch counts key it."""
    from deeplearning4j_tpu_torch.nn.helpers import pallas_conv

    return pallas_conv._DTYPE_NAMES.get(dtype, str(dtype))


class _Recording:
    """What one call did, op by op."""

    def __init__(self, torch, inplace: Dict[int, Tuple[int, int]]):
        self.torch = torch
        self.ops = 0
        self.kernel_ops = 0          # aten ops inside a kernel's scope
        self.kernel_depth = 0
        self.kernels: Dict[str, int] = {}   # "name/route/dtype" -> calls
        self.traffic = 0
        self.churn = 0
        self.churn_ops = 0
        self.churn_by_op: Dict[str, int] = {}
        self.matmuls = 0
        self.f32_matmuls: List[str] = []
        self.host: List[str] = []
        self.whole_copies: List[Tuple[str, int]] = []   # (op, argnum)
        self.inplace = inplace      # storage ptr -> (argnum, bytes)
        self._views: Dict[int, Tuple[Any, int]] = {}

    # ------------------------------------------------------- helpers
    @staticmethod
    def _nbytes(t) -> int:
        try:
            return int(t.numel()) * t.element_size()
        except Exception:   # noqa: BLE001 - sparse/meta: no bytes
            return 0

    @staticmethod
    def _storage(t) -> Optional[int]:
        try:
            return t.untyped_storage().data_ptr()
        except Exception:   # noqa: BLE001 - no storage (sparse/meta)
            return None

    def _churn(self, name: str, nbytes: int) -> None:
        self.churn += nbytes
        self.churn_ops += 1
        self.churn_by_op[name] = self.churn_by_op.get(name, 0) + nbytes

    # ---------------------------------------------------------- ops
    def note(self, func, args, kwargs, out) -> None:
        from torch.utils._pytree import tree_flatten

        torch = self.torch
        name = func.overloadpacket.__name__
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        self.ops += 1
        if name in HOST_SYNC_OPS:
            self.host.append(name)
        elif name in ("_to_copy", "copy_"):
            src = ins[1] if name == "copy_" and len(ins) > 1 else \
                (ins[0] if ins else None)
            dst = ins[0] if name == "copy_" else (outs[0] if outs else None)
            if src is not None and dst is not None \
                    and src.device.type != "cpu" \
                    and dst.device.type == "cpu":
                self.host.append(f"{name} to cpu")
        if self.kernel_depth:
            self.kernel_ops += 1
            return
        rets = func._schema.returns
        aliased = bool(rets) and rets[0].alias_info is not None
        # a view moves nothing; an in-place op reads its operands and
        # writes into one of them; any other op reads them and writes
        # its outputs
        if not aliased or name.endswith("_"):
            self.traffic += sum(self._nbytes(t) for t in ins)
        if not aliased:
            self.traffic += sum(self._nbytes(t) for t in outs)
        # a transposed view read by anything but a matmul moves its bytes
        # (a copy of it counts as the copy)
        for t in ins:
            ent = self._views.pop(id(t), None)
            if ent is not None and ent[0]() is t \
                    and name not in MATMUL_OPS and name not in COPY_OPS:
                self._churn(f"{ent[2]}->{name}", ent[1])
        if name in LAYOUT_VIEW_OPS and outs \
                and not outs[0].is_contiguous():
            self._views[id(outs[0])] = (weakref.ref(outs[0]),
                                        self._nbytes(outs[0]), name)
        if name in COPY_OPS:
            if name == "copy_" and len(ins) > 1:
                if ins[0].dtype == ins[1].dtype \
                        and ins[0].device == ins[1].device:
                    self._churn(name, self._nbytes(ins[0]))
            elif name == "_to_copy" and ins and outs:
                if ins[0].dtype == outs[0].dtype \
                        and ins[0].device == outs[0].device:
                    self._churn(name, self._nbytes(outs[0]))
            elif outs:
                self._churn(name, self._nbytes(outs[0]))
        if name in MATMUL_OPS:
            self.matmuls += 1
            dts = [t.dtype for t in ins[:2]]
            if any(d in (torch.float32, torch.float64) for d in dts):
                self.f32_matmuls.append(
                    f"{name} {' x '.join(_short(d) for d in dts)}")
        if self.inplace:
            self._whole_copy(name, ins, outs, aliased)

    def _whole_copy(self, name, ins, outs, aliased) -> None:
        if name == "copy_" and len(ins) > 1:
            src, dst = ins[1], ins[0]
            sp = self._storage(src)
            if sp in self.inplace and self._storage(dst) != sp \
                    and self._nbytes(src) >= self.inplace[sp][1]:
                self.whole_copies.append((name, self.inplace[sp][0]))
            return
        if aliased or name not in WHOLE_COPY_OPS:
            return
        big = max((self._nbytes(o) for o in outs), default=0)
        sp = self._storage(ins[0]) if ins else None
        if sp in self.inplace:
            argnum, whole = self.inplace[sp]
            if self._nbytes(ins[0]) >= whole and big >= whole:
                self.whole_copies.append((name, argnum))

    # ------------------------------------------------------- kernels
    def kernel(self, name, fn, args, kwargs):
        from deeplearning4j_tpu_torch.nn.helpers import pallas_conv

        torch = self.torch
        before = dict(pallas_conv.LAUNCHES_BY_DTYPE)
        self.kernel_depth += 1
        try:
            res = fn(*args, **kwargs)
        finally:
            self.kernel_depth -= 1
        after = pallas_conv.LAUNCHES_BY_DTYPE
        delta = {k: after[k] - before.get(k, 0) for k in after
                 if after[k] != before.get(k, 0)}
        if delta:
            for (kname, route, dt), n in delta.items():
                key = f"{kname}/{route}/{dt}"
                self.kernels[key] = self.kernels.get(key, 0) + n
        else:
            x = next((a for a in args if isinstance(a, torch.Tensor)),
                     None)
            key = f"{name}/plain/{_short(getattr(x, 'dtype', None))}"
            self.kernels[key] = self.kernels.get(key, 0) + 1
        flat = list(args) + list(kwargs.values()) + (
            list(res) if isinstance(res, (tuple, list)) else [res])
        self.traffic += sum(self._nbytes(t) for t in flat
                            if isinstance(t, torch.Tensor))
        return res


def _tensor_leaves(torch, tree) -> list:
    from torch.utils._pytree import tree_flatten

    return [t for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor)]


def record_call(rec: ProgramRecord):
    """Call `rec.fn` once under the recorder. Returns (output,
    _Recording, in-place arguments' storage changes, wall seconds)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from deeplearning4j_tpu_torch.nn.helpers import pallas_conv

    inplace: Dict[int, Tuple[int, int]] = {}
    watched = []
    for argnum in rec.inplace_argnums:
        for t in _tensor_leaves(torch, rec.example_args[argnum]):
            sp = t.untyped_storage().data_ptr()
            inplace[sp] = (argnum, _Recording._nbytes(t))
            watched.append((argnum, t, t.data_ptr()))
    st = _Recording(torch, inplace)

    class _Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            st.note(func, args, kwargs, out)
            return out

    def scoped(name, fn):
        def call(*args, **kwargs):
            return st.kernel(name, fn, args, kwargs)
        return call

    with _PATCH_LOCK:
        real = {k: getattr(pallas_conv, k) for k in KERNELS}
        for k in KERNELS:
            setattr(pallas_conv, k, scoped(k, real[k]))
        t0 = time.perf_counter()
        try:
            with _Recorder():
                out = rec.fn(*rec.example_args, **rec.example_kwargs)
        finally:
            for k in KERNELS:
                setattr(pallas_conv, k, real[k])
            if rec.restore is not None:
                rec.restore()
        wall = time.perf_counter() - t0
    moved = [argnum for argnum, t, ptr in watched if t.data_ptr() != ptr]
    return out, st, moved, wall


# --------------------------------------------------------------- checks
def _lint_one(rec: ProgramRecord, th: Thresholds
              ) -> Tuple[List[Finding], dict]:
    findings: List[Finding] = []

    def finding(rule: str, message: str) -> None:
        findings.append(Finding(rule, rec.source, 1, message,
                                symbol=rec.name))

    report: Dict[str, Any] = {"name": rec.name,
                              "policy": rec.precision_policy}
    # ---- prog-excess-padding (metadata-only records) -----------------
    if rec.bucket_capacity:
        rows = rec.bucket_rows_per_dispatch or 0.0
        fill = rows / float(rec.bucket_capacity)
        report["bucket_fill"] = fill
        if fill < th.min_bucket_fill:
            finding(
                "prog-excess-padding",
                f"bucket capacity {rec.bucket_capacity} dispatches "
                f"{rows:g} rows on average (fill {fill:.2f} < "
                f"{th.min_bucket_fill:.2f}) — the tensor cores run mostly "
                f"padding")
    if rec.lint_result is not None:
        dicts, rep = rec.lint_result
        findings += [Finding(d["rule"], d["file"], d["line"],
                             d["message"], d.get("symbol", ""))
                     for d in dicts]
        report.update(rep)
    if rec.fn is None:
        report["summary"] = _summary(report)
        return findings, report

    import torch

    # ---- prog-unsharded-optimizer-state ------------------------------
    if rec.sharded_argnums and rec.shard_plan_bytes is not None:
        local = sum(_Recording._nbytes(t) for i in rec.sharded_argnums
                    for t in _tensor_leaves(torch, rec.example_args[i]))
        report["opt_state_bytes"] = local
        report["opt_plan_bytes"] = int(rec.shard_plan_bytes)
        if local > rec.shard_plan_bytes:
            finding(
                "prog-unsharded-optimizer-state",
                f"this rank holds more optimizer state in argument(s) "
                f"{list(rec.sharded_argnums)} than the MeshManager plan's "
                f"slice — the state is not sharded as declared (bytes in "
                f"the report)")

    in_storages = {t.untyped_storage().data_ptr()
                   for t in _tensor_leaves(torch, (rec.example_args,
                                                   rec.example_kwargs))}
    out, st, moved, wall = record_call(rec)
    report.update({
        "ops": st.ops, "kernel_internal_ops": st.kernel_ops,
        "wall_s": wall, "traffic_bytes": st.traffic,
        "churn_bytes": st.churn, "churn_ops": st.churn_ops,
        "churn_share": (st.churn / st.traffic) if st.traffic else 0.0,
        "churn_by_op": dict(sorted(st.churn_by_op.items(),
                                   key=lambda kv: -kv[1])[:6]),
        "matmul_ops": st.matmuls, "f32_matmul_ops": len(st.f32_matmuls),
        "host_syncs": sorted(set(st.host)), "host_sync_ops": len(st.host),
        "kernels": dict(sorted(st.kernels.items())),
        **({"notes": rec.notes} if rec.notes else {}),
    })

    # ---- prog-unhonored-donation -------------------------------------
    big = {argnum for sp, (argnum, nb) in st.inplace.items()
           if nb >= th.min_donated_bytes}
    moved = [a for a in moved if a in big]
    copies = [f"{op} of argument {a}" for op, a in st.whole_copies
              if a in big]
    if moved:
        finding(
            "prog-unhonored-donation",
            f"argument(s) {sorted(set(moved))} declared updated in place "
            f"changed storage during the call — the caller's buffer is "
            f"not the one updated")
    elif copies:
        finding(
            "prog-unhonored-donation",
            f"an op copied an argument declared updated in place whole "
            f"(first: {copies[0]}) — the update pays a full copy and "
            f"twice the memory")

    # ---- prog-fp32-matmul-under-policy -------------------------------
    if rec.precision_policy in MIXED_POLICIES:
        bad_k = {k: n for k, n in st.kernels.items()
                 if k.split("/")[1] == "simple"
                 or k.split("/")[2] in ("f32", "f64")}
        n_k = sum(st.kernels.values())
        n_bad = len(st.f32_matmuls) + sum(bad_k.values())
        if n_bad:
            first = st.f32_matmuls[0] if st.f32_matmuls \
                else next(iter(bad_k))
            report["policy_violations"] = n_bad
            finding(
                "prog-fp32-matmul-under-policy",
                f"matmul op(s)/kernel call(s) compute in f32 or on the "
                f"simple route under the declared {rec.precision_policy} "
                f"policy (first: {first}; counts in the report)")

    # ---- prog-hidden-host-transfer -----------------------------------
    if rec.hot and st.host:
        finding(
            "prog-hidden-host-transfer",
            f"host read(s) inside the program: "
            f"{', '.join(sorted(set(st.host))[:4])} — every call blocks "
            f"the host on the device")

    # ---- prog-dead-output --------------------------------------------
    if rec.consumed_outputs is not None \
            and isinstance(out, (tuple, list)):
        consumed = set(rec.consumed_outputs)
        for i, o in enumerate(out):
            if i in consumed:
                continue
            ls = _tensor_leaves(torch, o)
            computed = [t for t in ls
                        if t.untyped_storage().data_ptr()
                        not in in_storages]
            if computed:
                finding(
                    "prog-dead-output",
                    f"output {i} is computed but no caller consumes it — "
                    f"wasted flops and memory")

    # ---- prog-transpose-churn ----------------------------------------
    if (st.churn_ops >= th.transpose_min_ops and st.traffic
            and st.churn / st.traffic >= th.transpose_bytes_frac):
        finding(
            "prog-transpose-churn",
            f"permute/contiguous/clone/copy ops move at least "
            f"{th.transpose_bytes_frac:.0%} of program traffic — layout "
            f"thrash (bytes and share in the report)")
    report["summary"] = _summary(report)
    return findings, report


def _summary(rep: dict) -> str:
    parts = [rep["name"], f"policy={rep.get('policy')}"]
    if "ops" in rep:
        parts += [f"ops={rep['ops']}",
                  f"matmul={rep['matmul_ops']}",
                  f"f32_matmul={rep['f32_matmul_ops']}",
                  f"churn={rep['churn_bytes']}B"
                  f"({rep['churn_share']:.1%},{rep['churn_ops']} ops)",
                  f"host_syncs={rep['host_sync_ops']}"]
        if rep["kernels"]:
            parts.append("kernels=" + ",".join(
                f"{k}:{v}" for k, v in rep["kernels"].items()))
    if "bucket_fill" in rep:
        parts.append(f"fill={rep['bucket_fill']:.2f}")
    if "opt_state_bytes" in rep:
        parts.append(f"opt_state={rep['opt_state_bytes']}B"
                     f"/plan={rep['opt_plan_bytes']}B")
    return " ".join(parts)


# ------------------------------------------------------------------ run
def run_with_reports(records: Sequence[ProgramRecord],
                     thresholds: Optional[Thresholds] = None
                     ) -> Tuple[List[Finding], List[dict]]:
    """Lint every record: (findings, one report per record with the
    numbers each rule read)."""
    th = thresholds or Thresholds()
    findings: List[Finding] = []
    reports: List[dict] = []
    for rec in records:
        f, rep = _lint_one(rec, th)
        findings.extend(f)
        reports.append(rep)
    findings.sort(key=lambda f: (f.file, f.symbol, f.rule))
    return findings, reports


def run(records: Sequence[ProgramRecord],
        thresholds: Optional[Thresholds] = None) -> List[Finding]:
    """Lint every record; findings are fingerprintable (file = the
    program's owning source, symbol = the program name, line-free
    message) so the baseline/pragma machinery applies unchanged."""
    return run_with_reports(records, thresholds)[0]
