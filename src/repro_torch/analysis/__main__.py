"""``python -m repro_torch.analysis`` — see ``cli``.

The guard matters: WIRE-001 spawns its world of ranks with the ``spawn``
start method, whose children import this module again.
"""

if __name__ == "__main__":
    from repro_torch.analysis.cli import main

    main()
