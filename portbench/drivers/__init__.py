"""Traffic drivers, one file per traffic ``kind``: set-up from the seed,
the measured window, the traced stretch and the check against the plain
reference."""
