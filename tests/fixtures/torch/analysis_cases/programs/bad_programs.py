"""One deliberately broken ProgramRecord per prog-* rule (true positives
for the port's analysis/program_lint): real torch programs on the CPU,
each called once under the op recorder."""

from deeplearning4j_tpu_torch.analysis.program_lint import ProgramRecord

SRC = "tests/fixtures/torch/analysis_cases/programs/bad_programs.py"


def build_records():
    import torch

    records = []

    # prog-fp32-matmul-under-policy: an f32 product under a declared
    # bf16 policy (the cast the policy promises never happens)
    def fp32_matmul(w, b, x):
        return x @ w + b

    records.append(ProgramRecord(
        name="bad_fp32_matmul", fn=fp32_matmul,
        example_args=(torch.zeros(16, 8), torch.zeros(8),
                      torch.zeros(4, 16)),
        precision_policy="bf16", source=SRC))

    # prog-unhonored-donation: the pool is declared updated in place,
    # the program updates a whole copy of it and returns that
    def copying_update(pool, rows):
        out = pool.clone()
        out[rows] += 1.0
        return out

    records.append(ProgramRecord(
        name="bad_unhonored_donation", fn=copying_update,
        example_args=(torch.zeros(64, 64), torch.tensor([1, 2])),
        inplace_argnums=(0,), source=SRC))

    # prog-transpose-churn: eight materialized layout round trips of the
    # whole activation
    def churny(x):
        acc = x
        for _ in range(8):
            acc = acc.t().contiguous()
        return acc + 1.0

    records.append(ProgramRecord(
        name="bad_transpose_churn", fn=churny,
        example_args=(torch.zeros(128, 128),), source=SRC))

    # prog-hidden-host-transfer: a host read inside the program
    def hosty(x):
        return x * float(x.abs().max()) + 1.0

    records.append(ProgramRecord(
        name="bad_host_transfer", fn=hosty,
        example_args=(torch.ones(4, 4),), source=SRC))

    # prog-dead-output: output 1 is computed but declared unconsumed
    def deady(x):
        return x + 1.0, torch.tanh(x) @ x.T

    records.append(ProgramRecord(
        name="bad_dead_output", fn=deady,
        example_args=(torch.zeros(8, 8),), consumed_outputs=(0,),
        source=SRC))

    # prog-excess-padding: 3 real rows per dispatch into a 32-bucket
    records.append(ProgramRecord(
        name="bad_excess_padding", bucket_capacity=32,
        bucket_rows_per_dispatch=3.0, source=SRC))

    # prog-unsharded-optimizer-state: the registration declares the
    # optimizer state sharded to 1/4 per rank, the rank holds it whole
    def unsharded_opt(p, m, x):
        m2 = 0.9 * m + x.mean()
        return p - 0.1 * m2, m2

    records.append(ProgramRecord(
        name="bad_unsharded_optimizer", fn=unsharded_opt,
        example_args=(torch.zeros(16, 4), torch.zeros(16, 4),
                      torch.ones(8)),
        sharded_argnums=(1,), shard_plan_bytes=16 * 4 * 4 // 4,
        source=SRC))
    return records
