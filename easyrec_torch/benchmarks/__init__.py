"""The packed-group prototypes of the JAX package's benchmarks/, ported.

Each module keeps its counterpart's name (without "pallas") and runs on
the card by default: `python -m easyrec_torch.benchmarks.<name>`, with
`--device cpu` only when asked. Nothing runs or allocates at import.
"""
