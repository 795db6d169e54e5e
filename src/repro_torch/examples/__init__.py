"""The JAX package's examples on the port: ``quickstart`` and
``train_dlrm_criteo``, each run as ``python -m repro_torch.examples.<name>``
with ``--device`` (default ``cuda``)."""
