"""Operator scripts of the port, the counterparts of the JAX package's
``scripts/`` that drive the serving stack: ``blackbox_read`` (read a
crash black-box bundle) and ``chaos_soak`` (the soak's hard-death arm).
Run each as ``python -m dj_tpu_torch.scripts.<name>``."""
