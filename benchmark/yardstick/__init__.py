"""The benchmark's yardstick: what later changes to the program cannot
move. Traffic generation lives in `traffic/`, per-layer readers in
`metrics/`, the plain reference in `reference/`; this package holds what
they share: finding cells, configurations and readers by name
(`manifest`), the chip's peaks (`peaks`), operation and byte counts
(`flops`), seeded weights and inputs (`weights`), the reduction of a
profiler trace (`trace`), the device facts and the no-JAX guard
(`device`), building the program under test (`program`) and the
comparisons that decide `correct` (`checks`)."""
