"""The benchmark of easyrec_torch on one NVIDIA H100.

    python3 -m recbench.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

BENCHMARK.json at the repository root names the cells, the metrics and
their bounds. Everything that belongs to one cell, configuration, traffic
mix or metric is a file of its own that the harness finds by name:

    recbench/workloads/<cell>.json    the cell's limits of `correct`
    recbench/configs/<config>.json    sizes, environment, source; with
    recbench/configs/<config>.config  the pipeline config the port runs
    recbench/reference/<config>.py    the plain PyTorch reference model
    recbench/traffic/<traffic>.json   parameters of the batch generator
    recbench/metrics/<metric>.py      one reader a metric (one line for
                                      a span of the port's: spans.py
                                      span_reader)

Nothing here imports jax, flax or the JAX package, and the reference
imports nothing of easyrec_torch.
"""
