"""The JAX package's examples on the port: ``quickstart``,
``train_dlrm_criteo`` and ``serve_lm``, each run as
``python -m repro_torch.examples.<name>`` with ``--device`` (default
``cuda``)."""
