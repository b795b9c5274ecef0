"""Hardware probes, one module for each probe of the JAX package's
``scripts/hw/`` that holds a TPU kernel: ``probe_sort`` and
``probe_gather``; ``gather_variants`` times variants of the gather's
kernel. Run each as ``python -m dj_tpu_torch.hw.<probe>``."""
