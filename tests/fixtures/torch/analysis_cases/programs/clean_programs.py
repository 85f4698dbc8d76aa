"""The false-positive guard per prog-* rule: each record sits just on
the CLEAN side of the behavior its bad_programs twin violates."""

from deeplearning4j_tpu_torch.analysis.program_lint import ProgramRecord

SRC = "tests/fixtures/torch/analysis_cases/programs/clean_programs.py"


def build_records():
    import torch

    records = []

    # bf16 product under the bf16 policy; the f32 master-param add after
    # the cast must NOT flag
    def bf16_matmul(w, b, x):
        y = x.to(torch.bfloat16) @ w.to(torch.bfloat16)
        return b + y.to(torch.float32)

    records.append(ProgramRecord(
        name="clean_bf16_matmul", fn=bf16_matmul,
        example_args=(torch.zeros(16, 8), torch.zeros(8),
                      torch.zeros(4, 16)),
        precision_policy="bf16", source=SRC))

    # the pool updated in place, rows gathered and scattered: no copy
    def inplace_update(pool, rows):
        pool[rows] += 1.0
        return pool

    records.append(ProgramRecord(
        name="clean_inplace_update", fn=inplace_update,
        example_args=(torch.zeros(64, 64), torch.tensor([1, 2])),
        inplace_argnums=(0,), consumed_outputs=(0,), source=SRC))

    # one materialized transpose (a backward's weight transpose) stays
    # under the churn threshold, and a transposed operand a matmul reads
    # in place moves nothing
    def one_transpose(x, w):
        return x.t().contiguous() @ w.t() + 1.0

    records.append(ProgramRecord(
        name="clean_single_transpose", fn=one_transpose,
        example_args=(torch.zeros(128, 128), torch.zeros(64, 128)),
        source=SRC))

    # pure device program: no host reads
    def devicey(x):
        return torch.tanh(x) + x.abs().amax()

    records.append(ProgramRecord(
        name="clean_device_only", fn=devicey,
        example_args=(torch.ones(4, 4),), source=SRC))

    # every output consumed
    def both(x):
        return x + 1.0, torch.tanh(x)

    records.append(ProgramRecord(
        name="clean_outputs", fn=both, example_args=(torch.zeros(8, 8),),
        consumed_outputs=(0, 1), source=SRC))

    # full buckets
    records.append(ProgramRecord(
        name="clean_bucket_fill", bucket_capacity=32,
        bucket_rows_per_dispatch=30.0, source=SRC))

    # the state this rank holds is the plan's slice
    def sharded_opt(p, m, x):
        m2 = 0.9 * m + x.mean()
        return p - 0.1 * m2.repeat(4, 1), m2

    records.append(ProgramRecord(
        name="clean_sharded_optimizer", fn=sharded_opt,
        example_args=(torch.zeros(16, 4), torch.zeros(4, 4),
                      torch.ones(8)),
        sharded_argnums=(1,), shard_plan_bytes=16 * 4 * 4 // 4,
        source=SRC))
    return records
