"""The benchmark of the PyTorch + CUDA port (``hsi_dmgasr_tpu_torch``) on
an NVIDIA H100: ``python3 -m portbench.run`` runs one cell of
``BENCHMARK.json`` once (see ``run.py``). It imports neither JAX nor the
JAX package; ``reference/`` imports nothing of the port either."""
