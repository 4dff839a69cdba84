"""Benchmarks of the port (twins of the JAX package's root ``bench.py`` and
of its ``bench/`` probes): ``train_throughput``, ``scatter_probe`` (P1)
and ``gather_probe`` (P2).  Each runs as ``python3 -m
satrans_torch.bench.<name>``; nothing is built when they are imported."""
