"""The port's example drivers, each run with ``python -m`` and the flags of
the JAX package's script of the same name (the repository's
``examples/``): ``train_synthetic`` (the synthetic-data quality gate: a
generated shapes dataset, the preprocessing, then XE, greedy and beam-3
val evals, SCST and a sample through the port's CLI, and a PASS/FAIL
record), ``demo_e2e`` (a few XE steps, greedy and beam-3 decodes scored
with CIDEr-D and BLEU) and ``demo_scst`` (XE, then SCST with the CIDEr-D
reward on the device).  Each takes ``--gpu_id``: ``0`` (the default) is
``cuda:0``, ``cpu`` runs the kernels' plain versions on the CPU.  They
import neither JAX nor the JAX package."""
