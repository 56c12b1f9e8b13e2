"""The benchmark of the PyTorch and CUDA port (``vae_tagger_tpu_torch``).

``python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; see ``run.py``.  The
harness imports neither JAX nor the JAX package, and its reference
(``reference/``) imports nothing of the program.
"""
